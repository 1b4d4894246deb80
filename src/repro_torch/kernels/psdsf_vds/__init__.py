"""Per-server min-VDS reduction (Eq. 16): the kernel wrapper (``kernel``),
the any-shape entry (``ops``) and the plain PyTorch version (``ref``)."""
