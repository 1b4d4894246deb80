"""Mamba-2 mixer via the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060), ngroups = 1 — the port of ``repro/models/ssm.py``.

Prefill's SSD goes through ``kernels/ssd_scan``: on the card that is the
Hopper kernel (the reference's model computes it with jnp in
``_ssd_chunked`` and never calls its Pallas kernel). With autograd on
(training) ``mamba_train`` takes ``ops.ssd_chunked_train``: the kernel's
forward and the plain version's backward. A decode step is the
single-step recurrence in plain torch, as in the reference, and updates its
cache IN PLACE.

Layer I/O:
  prefill: x (B, S, D) -> y (B, S, D) [+ {"conv": (B, k-1, convdim),
           "ssm": (B, H, P, N) float32}]
  decode:  x (B, 1, D) with that cache, updated in place.

On a mesh the SSD and the decode step's recurrence run on each device's
batch and head shards (``local_map`` regions).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..kernels.ssd_scan.ops import ssd_chunked, ssd_chunked_train
from .common import (constrain_torch, dense_init, layout_of_torch,
                     local_region_torch, mm_promoted_torch,
                     placements_of_torch, shard_axes_torch, unshard_dp_torch)
from .config import ModelConfig


def _param(t):
    return torch.nn.Parameter(t, requires_grad=False)


class Mamba(torch.nn.Module):
    """Params of one mixer in the reference's (in, out) layout
    (``init_mamba``): ``in_proj`` (d, 2 di + 2 N + H) -> [z, x, B, C, dt],
    ``conv_w`` (k, convdim), ``conv_b``, ``out_proj`` (di, d) in the params'
    dtype; ``A_log``, ``D`` and ``dt_bias`` (H,) always float32."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device=None):
        super().__init__()
        d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * n
        self.in_proj = _param(dense_init(generator, (d, 2 * di + 2 * n + nh),
                                         dtype, device=device))
        self.conv_w = _param(dense_init(generator, (cfg.ssm_conv, conv_dim),
                                        dtype, device=device))
        self.conv_b = _param(torch.zeros((conv_dim,), dtype=dtype,
                                         device=device))
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = _param(torch.zeros((nh,), **f32))
        self.D = _param(torch.ones((nh,), **f32))
        self.dt_bias = _param(torch.zeros((nh,), **f32))
        self.out_proj = _param(dense_init(generator, (di, d), dtype,
                                          device=device))


def _split_proj(cfg: ModelConfig, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:di + di + 2 * n],
            proj[..., di + di + 2 * n:])


def _softplus(v):
    """jax.nn.softplus's form, ``logaddexp(v, 0)``."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _causal_conv(p: Mamba, xbc):
    """Depthwise causal conv over (B, S, C) with kernel (k, C): the
    reference's k shifted products, summed in its order (not
    ``F.conv1d``, which cuDNN runs in TF32 for float32)."""
    k, s = p.conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * p.conv_w[i] for i in range(k))
    return F.silu(out + p.conv_b)


def _ssd_region_torch(cfg: ModelConfig, name: str, fn, with_state: bool,
                      xin, dt, a, b_mat, c_mat):
    """``fn(xin, dt, a, b_mat, c_mat)``; on DTensors in
    ``local_region_torch``: batch over the dp axes and heads over the tp
    axis where they divide, B and C whole on each device, so each device
    runs the SSD kernel (its plain version on CPU tensors) on its shards.
    Returns y, and the final state when ``with_state``."""
    if not isinstance(xin, DTensor):
        return fn(xin, dt, a, b_mat, c_mat)
    mesh = xin.device_mesh
    dp = shard_axes_torch(cfg, mesh, "dp", xin.shape[0])
    tp = shard_axes_torch(cfg, mesh, "tp", xin.shape[2])
    x_lay = (dp, (), tp, ())
    outs = (x_lay, (dp, tp, (), ())) if with_state else (x_lay,)
    return local_region_torch(
        name, fn, (x_lay, (dp, (), tp), (tp,), (dp, (), ()), (dp, (), ())),
        outs, xin, dt, a, b_mat, c_mat)


def mamba_train(cfg: ModelConfig, p: Mamba, x, return_state: bool = False):
    """Full-sequence SSD pass from an empty state. x: (B, S, D). With
    ``return_state`` also returns the decode cache: ``conv``, the last k-1
    pre-activation conv inputs, right-aligned with zeros first when S <
    k-1 (what the causal conv saw; the reference returns only S rows then),
    and ``ssm``, the final state in float32. With autograd on and no
    state asked for, the SSD is ``ssd_chunked_train`` (differentiable on
    the card too)."""
    bsz, s, _ = x.shape
    di, n, nh, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    proj = constrain_torch(mm_promoted_torch(
        x, unshard_dp_torch(p.in_proj, cfg)), cfg, "dp", None, "tp")
    z, xbc_in, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(p, xbc_in)
    xin = xbc[..., :di].reshape(bsz, s, nh, ph)
    b_mat = xbc[..., di:di + n]
    c_mat = xbc[..., di + n:]
    dt = _softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.A_log)
    if torch.is_grad_enabled() and not return_state:
        y = _ssd_region_torch(
            cfg, "ssd_chunked_train", lambda *t: ssd_chunked_train(
                *t, chunk=cfg.ssm_chunk), False, xin, dt, a, b_mat, c_mat)
    else:
        y, state = _ssd_region_torch(
            cfg, "ssd_scan", lambda *t: ssd_chunked(
                *t, chunk=cfg.ssm_chunk), True, xin, dt, a, b_mat, c_mat)
    y = y + xin * p.D[None, None, :, None].to(x.dtype)
    y = y.reshape(bsz, s, di) * F.silu(z)
    out = mm_promoted_torch(y, unshard_dp_torch(p.out_proj, cfg))
    if return_state:
        k = cfg.ssm_conv
        tail = F.pad(xbc_in, (0, 0, max(0, k - 1 - s), 0))[:, -(k - 1):]
        return out, {"conv": tail, "ssm": state}
    return out


def _ssm_step_torch(state, xin, dt1, a, b_mat, c_mat, d_skip):
    """One recurrence step, ``state`` (B, H, P, N) float32 updated in
    place: state = exp(dt a) state + dt x B; returns y = state C + D x
    (B, H, P) float32."""
    decay = torch.exp(dt1 * a[None, :])
    state.mul_(decay[:, :, None, None]).add_(
        dt1[:, :, None, None] * xin[:, :, :, None] * b_mat[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, c_mat)
    return y + xin * d_skip[None, :, None]


def mamba_decode(cfg: ModelConfig, p: Mamba, x, cache: dict):
    """Single-token step. x: (B, 1, D); cache: conv (B, k-1, convdim) in
    the compute dtype, ssm (B, H, P, N) float32, both updated IN PLACE (the
    reference returns a new cache). Returns (y (B, 1, D), cache)."""
    bsz = x.shape[0]
    di, n, nh, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    proj = mm_promoted_torch(x, unshard_dp_torch(p.in_proj, cfg))
    z, xbc_new, dt = _split_proj(cfg, proj)
    window = torch.cat([cache["conv"], xbc_new], dim=1)      # (B, k, C)
    conv_out = (window * p.conv_w).sum(dim=1) + p.conv_b
    xbc = F.silu(conv_out)
    xin = xbc[:, :di].reshape(bsz, nh, ph).float()
    b_mat = xbc[:, di:di + n].float()
    c_mat = xbc[:, di + n:].float()
    dt1 = _softplus(dt[:, 0].float() + p.dt_bias)             # (B, H)
    a = -torch.exp(p.A_log)
    state = cache["ssm"]
    if isinstance(state, DTensor):    # each device steps its own shard
        bl, hl, pl, nl = layout_of_torch(state)
        xl = (bl, hl, pl)
        y = local_region_torch(
            "mamba decode step", _ssm_step_torch,
            ((bl, hl, pl, nl), xl, (bl, hl), (hl,), (bl, nl), (bl, nl),
             (hl,)), (xl,), state, xin.reshape(bsz, nh, ph), dt1, a, b_mat,
            c_mat, p.D)
        # P whole before (H, P) flattens: a flat dim takes one shard
        y = y.redistribute(y.device_mesh,
                           placements_of_torch(y.device_mesh, (bl, hl, ())))
    else:
        y = _ssm_step_torch(state, xin, dt1, a, b_mat, c_mat, p.D)
    y = y.reshape(bsz, 1, di).to(x.dtype) * F.silu(z)
    cache["conv"].copy_(window[:, 1:])
    return mm_promoted_torch(y, unshard_dp_torch(p.out_proj, cfg)), cache
