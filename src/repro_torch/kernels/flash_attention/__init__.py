"""Causal GQA flash attention for prefill: the kernel wrapper (``kernel``),
the model-facing entry (``ops``) and the plain PyTorch version (``ref``)."""
