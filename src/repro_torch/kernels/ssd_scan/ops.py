"""``ssd_scan`` in the model's (B, S, H, P) layout: the port of
``repro/kernels/ssd_scan/ops.py``. The reference transposes x and dt to
(B, H, S, P) for its kernel and y back; the port's kernel reads x and dt
and writes y through strides, so nothing is transposed or copied.

``ssd_chunked`` writes the kernel's y through a raw pointer, so on the card
its y has no ``grad_fn``. ``ssd_chunked_train`` (the training path's call)
is differentiable: ``_SsdTrain``'s forward is the kernel and its backward
re-runs the plain version (``ref.py``) on the saved inputs under autograd
and backpropagates through it, as the reference differentiates its jnp
``_ssd_chunked`` (``repro/models/ssm.py:58``)."""
from __future__ import annotations

import torch

from . import ref
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


class _SsdTrain(torch.autograd.Function):
    """y = SSD(x, dt, a, b, c) with the kernel forward and the plain
    version's gradient: x (B, S, H, P), dt (B, S, H) float32, a (H,)
    float32, b/c (B, S, N) -> y (B, S, H, P) in x's dtype."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, chunk):
        y, _ = ssd_chunked(x, dt, a, b_mat, c_mat, chunk=chunk)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        x, dt, a, b_mat, c_mat = inputs
        with torch.enable_grad():
            y, _ = ref.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), a,
                                b_mat, c_mat, chunk=ctx.chunk)
            y = y.transpose(1, 2)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None)


def ssd_chunked_train(x, dt, a, b_mat, c_mat, *, chunk: int = 128):
    """``ssd_chunked``'s y from an empty state, differentiable in every
    input (``_SsdTrain``): the training path's SSD."""
    return _SsdTrain.apply(x, dt, a, b_mat, c_mat, chunk)
