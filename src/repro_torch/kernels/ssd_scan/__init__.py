"""Mamba-2 SSD chunked scan (ngroups = 1) for prefill: the kernel wrapper
(``kernel``), the model-facing entry (``ops``) and the plain PyTorch
version (``ref``)."""
