"""``ssd_scan`` in the model's (B, S, H, P) layout: the port of
``repro/kernels/ssd_scan/ops.py``. The reference transposes x and dt to
(B, H, S, P) for its kernel and y back; the port's kernel reads x and dt
and writes y through strides, so nothing is transposed or copied."""
from __future__ import annotations

import torch

from .kernel import ssd_scan as _kernel


def ssd_chunked(x, dt, a, b_mat, c_mat, *, chunk: int = 128,
                init_state=None):
    """The core of ``repro.models.ssm._ssd_chunked`` (without the D skip
    and gating, which stay in the layer): x (B, S, H, P), dt (B, S, H)
    float32, a (H,) float32, b/c (B, S, N) -> (y (B, S, H, P) contiguous in
    x's dtype, final state (B, H, P, N) float32)."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _, state = _kernel(x.transpose(1, 2), dt.transpose(1, 2), a, b_mat,
                       c_mat, chunk=chunk, init_state=init_state,
                       out=y.transpose(1, 2))
    return y, state
