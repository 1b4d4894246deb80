"""Shared layers: dtypes, initializers, RMSNorm, activations, RoPE and
M-RoPE — the port of ``repro/models/common.py``.

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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections):
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191), as the reference's
    ``apply_mrope``: x (B, S, H, D); positions (3, B, S) int, the
    temporal, height and width ids. ``sections`` (summing to D/2) split the
    half dim's frequency slots, and each slot rotates by its section's
    component. The reference picks the component with a one-hot sum (the
    other terms are x 0); a gather picks the same product, so the angles
    are bit for bit the reference's, and with t == h == w ``apply_rope``'s.
    """
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {d_half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)      # (D/2,)
    # (B, S, D/2): each frequency slot's component, section by section
    pos = torch.cat([positions[c, :, :, None].expand(-1, -1, n)
                     for c, n in enumerate(sections)], dim=-1).float()
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
