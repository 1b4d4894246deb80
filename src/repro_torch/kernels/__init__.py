"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the reference, each a ``kernel.py`` (ctypes wrapper around the CUDA source
in ``csrc/``), ``ops.py`` (the caller-facing loop) and ``ref.py`` (the plain
PyTorch version). Nothing here builds or loads a kernel at import time."""
