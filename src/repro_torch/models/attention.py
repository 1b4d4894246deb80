"""Grouped-query attention with optional QKV bias and qk-norm, RoPE, and a
decode path over a preallocated KV cache — the port of
``repro/models/attention.py`` for serving.

Prefill goes through ``kernels/flash_attention`` and every decode step
through ``kernels/decode_attention``: on the card those are the Hopper
kernels (the reference's model computes attention with jnp in ``_attend``
and never calls its Pallas kernels). ``_attend`` is ported as the plain
path the tests hold the kernels' plain versions against. The training-only
custom-vjp flash (``attention.py:149-254``), sliding windows, M-RoPE and a
quantized cache wait for the slices that need them.
"""
from __future__ import annotations

import math

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .common import RMSNorm, apply_rope, dense_init
from .config import ModelConfig

NEG_INF = -1e30


def _param(t):
    return torch.nn.Parameter(t, requires_grad=False)


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for attention options the port has
    not ported yet."""
    if cfg.rope_type not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: rope_type={cfg.rope_type!r} (M-RoPE) waits for "
            f"qwen2_vl_72b (ROADMAP.md queue 1 item 9, M-RoPE and the "
            f"frontend stubs)")
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is not in the port's "
            f"kernels yet (no config the repository ships sets it; ROADMAP.md "
            f"queue 1 item 8, remaining dense configs)")
    if cfg.cache_dtype:
        raise NotImplementedError(
            f"{cfg.name}: a {cfg.cache_dtype} KV cache is not in the port's "
            f"kernels yet (no config the repository ships sets it; ROADMAP.md "
            f"queue 1 item 8, remaining dense configs)")


class Attention(torch.nn.Module):
    """Projections stored flattened, (d_model, H*hd), in the reference's
    (in, out) layout and applied as ``x @ W``."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device=None):
        super().__init__()
        check_supported(cfg)
        self.wq = _param(dense_init(generator, (cfg.d_model, cfg.q_dim), dtype,
                                    device=device))
        self.wk = _param(dense_init(generator, (cfg.d_model, cfg.kv_dim),
                                    dtype, device=device))
        self.wv = _param(dense_init(generator, (cfg.d_model, cfg.kv_dim),
                                    dtype, device=device))
        self.wo = _param(dense_init(generator, (cfg.q_dim, cfg.d_model), dtype,
                                    device=device))
        if cfg.qkv_bias:
            for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                              ("bv", cfg.kv_dim)):
                setattr(self, name, _param(torch.zeros((dim,), dtype=dtype,
                                                       device=device)))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, cfg.norm_eps, dtype, device)
            self.k_norm = RMSNorm(cfg.head_dim, cfg.norm_eps, dtype, device)


def _project_qkv(cfg: ModelConfig, p: Attention, x, positions):
    b, s, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = q.view(b, s, cfg.num_heads, cfg.head_dim)
    k = k.view(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.view(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if cfg.rope_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(cfg: ModelConfig, q, k, v, q_offset, kv_len_mask=None):
    """Causal GQA attention in the compute dtype, as the reference's
    ``_attend``: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); q position i
    attends kv position j iff j <= i + q_offset (and, with ``kv_len_mask``
    (B, Skv), iff the slot is valid). The model does not call it; the
    tests hold the kernels' plain versions against it."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if k.dtype != q.dtype:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    qg = q.reshape(b, sq, hkv, rep, d)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32).to(q.dtype)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg * scale, k).float()
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos <= qpos
    if cfg.sliding_window:
        mask &= kpos > qpos - cfg.sliding_window
    if kv_len_mask is not None:
        mask = mask[None] & kv_len_mask[:, None, :]
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    else:
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(b, sq, hq, d)


def attention_prefill(cfg: ModelConfig, p: Attention, x, positions):
    """Full-sequence causal attention from position 0; x: (B, S, D).
    Returns (y, {"k", "v"}: this layer's (B, S, Hkv, D) cache)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = flash_attention(q, k, v, causal=True)
    y = out.reshape(out.shape[0], out.shape[1], -1) @ p.wo
    return y, {"k": k, "v": v}


def attention_decode(cfg: ModelConfig, p: Attention, x, cache: dict, pos):
    """One-token decode. x: (B, 1, D); cache k/v: (B, S_max, Hkv, D),
    written IN PLACE at each sequence's ``pos`` (the reference rebuilds its
    immutable cache); pos: (B,) int tensor on x's device.

    As the reference's masked-select write, a sequence whose ``pos`` is
    past the cache writes nothing and attends its whole row: the write
    index is clamped and the old row kept there (``torch.where``), and the
    kernel's length is ``min(pos + 1, S_max)`` — all on the device, no
    host sync. Returns (y, cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x, pos[:, None])
    s_max = cache["k"].shape[1]
    inside = (pos < s_max)[:, None, None]
    rows = torch.arange(b, device=x.device)
    idx = pos.clamp(max=s_max - 1).long()
    for key, new in (("k", k_new), ("v", v_new)):
        c = cache[key]
        c[rows, idx] = torch.where(inside, new[:, 0].to(c.dtype), c[rows, idx])
    kv_len = (pos + 1).clamp(max=s_max).to(torch.int32)
    out = decode_attention(q, cache["k"], cache["v"], kv_len)
    y = out.reshape(b, 1, -1) @ p.wo
    return y, cache
