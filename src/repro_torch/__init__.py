"""PyTorch/CUDA port of the PS-DSF allocator (arXiv:1611.00404).

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy only, never ``jax`` and nothing of ``repro``. Its layout mirrors
the reference (``core/``, ``kernels/<name>/{kernel,ops,ref}.py``), so each
module's counterpart is found under the same path.

Entry points run on the card by default (``device="cuda"``) and raise when
there is none, unless the caller passes ``device="cpu"``: then every kernel
wrapper takes its plain PyTorch version instead of launching the kernel.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
