"""Grouped-query attention with optional QKV bias and qk-norm, RoPE, and a
decode path over a preallocated KV cache — the port of
``repro/models/attention.py``.

Prefill goes through ``kernels/flash_attention`` and every decode step
through ``kernels/decode_attention``: on the card those are the Hopper
kernels (the reference's model computes attention with jnp in ``_attend``
and never calls its Pallas kernels). ``_attend`` is ported as the plain
path the tests hold the kernels' plain versions against. M-RoPE
(``rope_type="mrope"``, qwen2_vl_72b) takes (3, B, S) positions.

Training (``attention_train_torch``) routes as the reference's
``_attend_any``: where ``cfg.attn_flash_block`` divides S and S exceeds it,
``_FlashTrain``, the reference's recompute-backward flash
(``_make_flash_train``, ``attention.py:195-254``) as a
``torch.autograd.Function`` whose forward is the flash kernel (it also
writes the rows' log-sum-exp) and whose backward is the reference's
``bwd`` in plain torch, one kv block at a time; else ``_attend`` under
autograd. Sliding windows and a quantized cache wait for ROADMAP item 13.
"""
from __future__ import annotations

import math

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .common import RMSNorm, apply_mrope, apply_rope, dense_init
from .config import ModelConfig

NEG_INF = -1e30


def _param(t):
    return torch.nn.Parameter(t, requires_grad=False)


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for attention options the port has
    not ported yet."""
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is not in the port's "
            f"kernels yet (no config the repository ships sets it; ROADMAP.md "
            f"queue 1 item 13, options no shipped config sets: sliding "
            f"window, quantized KV cache)")
    if cfg.cache_dtype:
        raise NotImplementedError(
            f"{cfg.name}: a {cfg.cache_dtype} KV cache is not in the port's "
            f"kernels yet (no config the repository ships sets it; ROADMAP.md "
            f"queue 1 item 13, options no shipped config sets: sliding "
            f"window, quantized KV cache)")


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
        pos2d = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos2d, cfg.rope_theta)
        k = apply_rope(k, pos2d, cfg.rope_theta)
    elif cfg.rope_type == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _attend(cfg: ModelConfig, q, k, v, q_offset, kv_len_mask=None):
    """Causal GQA attention in the compute dtype, as the reference's
    ``_attend``: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); q position i
    attends kv position j iff j <= i + q_offset (and, with ``kv_len_mask``
    (B, Skv), iff the slot is valid). Training takes it where
    ``_FlashTrain`` does not apply; the tests hold the kernels' plain
    versions against it."""
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


class _FlashTrain(torch.autograd.Function):
    """Causal GQA flash attention for training: q (B, S, Hq, D), k, v (B,
    S, Hkv, D) -> (B, S, Hq, D). The forward is the flash kernel with its
    log-sum-exp output (the plain version for CPU tensors) and saves (q, k,
    v, out, lse); the backward recomputes each kv block's probabilities
    from lse, as the reference's ``bwd`` (``attention.py:208-254``), in
    float32: delta = sum(dO O), P = exp(S - lse), dV = P^T dO, dP = dO V^T,
    dS = P (dP - delta), dQ = dS K scale, dK = dS^T Q scale, cast back to
    the inputs' dtypes. Its live memory is O(S x block), not O(S^2)."""

    @staticmethod
    def forward(ctx, q, k, v, block):
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block = block
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        block = ctx.block
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        rep = hq // hkv
        scale = 1.0 / math.sqrt(d)
        qg = (q.float() * scale).reshape(b, sq, hkv, rep, d)
        dog = do.float().reshape(b, sq, hkv, rep, d).permute(0, 2, 3, 1, 4)
        delta = (dog * out.float().reshape(b, sq, hkv, rep, d)
                 .permute(0, 2, 3, 1, 4)).sum(-1)           # (B,Hkv,rep,S)
        lse = lse.reshape(b, hkv, rep, sq)
        qpos = torch.arange(sq, device=q.device)[:, None]
        dq = torch.zeros((b, sq, hkv, rep, d), dtype=torch.float32,
                         device=q.device)
        dk = torch.empty((b, skv, hkv, d), dtype=torch.float32,
                         device=q.device)
        dv = torch.empty_like(dk)
        for j0 in range(0, skv, block):
            k_i = k[:, j0:j0 + block].float()
            v_i = v[:, j0:j0 + block].float()
            s_blk = torch.einsum("bqhrd,bkhd->bhrqk", qg, k_i)
            kpos = j0 + torch.arange(k_i.shape[1], device=q.device)[None, :]
            s_blk = torch.where(kpos <= qpos, s_blk, NEG_INF)
            p_blk = torch.exp(s_blk - lse[..., None])       # (B,Hkv,rep,S,bk)
            dv[:, j0:j0 + block] = torch.einsum("bhrqk,bhrqd->bkhd", p_blk,
                                                dog)
            dp = torch.einsum("bhrqd,bkhd->bhrqk", dog, v_i)
            ds = p_blk * (dp - delta[..., None])
            dq += torch.einsum("bhrqk,bkhd->bqhrd", ds, k_i)
            dk[:, j0:j0 + block] = torch.einsum("bhrqk,bqhrd->bkhd", ds, qg)
        dq = (dq * scale).reshape(b, sq, hq, d).to(q.dtype)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None


def _attend_any_torch(cfg: ModelConfig, q, k, v):
    """Causal attention for training, routed as the reference's
    ``_attend_any``: ``_FlashTrain`` where ``cfg.attn_flash_block``
    divides S and S exceeds it, else ``_attend`` (autograd through it)."""
    block = cfg.attn_flash_block
    if block and k.shape[1] % block == 0 and k.shape[1] > block:
        return _FlashTrain.apply(q, k, v, block)
    return _attend(cfg, q, k, v, 0)


def attention_train_torch(cfg: ModelConfig, p: Attention, x, positions):
    """Full-sequence causal attention with autograd (training); x: (B, S,
    D). The reference's ``attention_train``."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = _attend_any_torch(cfg, q, k, v)
    return out.reshape(out.shape[0], out.shape[1], -1) @ p.wo


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
    positions = pos[:, None]
    if cfg.rope_type == "mrope":        # (3, B, 1): t == h == w
        positions = positions[None].expand(3, b, 1)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
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
