"""One-token GQA attention over a KV cache for decode: the kernel wrapper
(``kernel``), the model-facing entry (``ops``) and the plain PyTorch
version (``ref``)."""
