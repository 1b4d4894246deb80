"""``flash_attention`` in the model's (B, S, H, D) layout: the port of
``repro/kernels/flash_attention/ops.py``. The reference transposes to
(B, H, S, D) for its kernel; the port's kernel reads (B, S, H, D) through
strides, so the op is the kernel's wrapper itself and nothing is
transposed or copied."""
from .kernel import flash_attention

__all__ = ["flash_attention"]
