"""Shared layers: dtypes, initializers, RMSNorm, activations, RoPE — the
port of ``repro/models/common.py``.

The same mixed-precision policy as the reference: params are stored in
``cfg.param_dtype``, matmuls run in the params' dtype, reductions (norms,
softmax) and the RoPE rotation run in float32. ``constrain`` (sharding
constraints) does not come across: the port runs on one card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# -- initializers -------------------------------------------------------------

def _truncated_normal(shape, std, dtype, generator, device):
    """N(0, 1) truncated to [-2, 2], times ``std``, drawn in float32 from
    ``generator`` and cast to ``dtype``; left uninitialized when
    ``generator`` is None (the caller loads weights into it)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (out.mul_(std)).to(dtype)


def dense_init(generator, shape, dtype, in_axis: int = 0, device=None):
    return _truncated_normal(shape, 1.0 / math.sqrt(shape[in_axis]), dtype,
                             generator, device)


def embed_init(generator, shape, dtype, std: float | None = None,
               device=None):
    if std is None:
        std = 1.0 / math.sqrt(shape[-1])     # keeps tied/untied logits O(1)
    return _truncated_normal(shape, std, dtype, generator, device)


# -- norms --------------------------------------------------------------------

class RMSNorm(torch.nn.Module):
    """``scale`` is stored as zeros and applied as ``1 + scale`` in
    float32, as the reference stores it (``common.py:60-68``)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = torch.nn.Parameter(
            torch.zeros((dim,), dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


def rmsnorm(scale, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# -- activations --------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "swiglu": F.silu,
            "geglu": _gelu_tanh}[name]


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D); positions: (B, S) int. Rotates the two *halves* of
    the head dim (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)      # (D/2,)
    angles = positions[..., None].float() * freqs                # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
