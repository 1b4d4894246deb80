"""Grouped-query attention with optional QKV bias, qk-norm, sliding window,
RoPE, and a decode path over a preallocated (optionally float8) KV cache —
the port of ``repro/models/attention.py``.

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
autograd.

``cfg.sliding_window`` W reaches both kernels: flash masks keys j <= i - W
and skips the kv tiles wholly below a block's window; a decode step passes
each sequence a first valid row, measured as the reference measures it
from the batch's largest position P (``q_offset=pos_b.max()``): rows (P -
W, pos_b] (ROADMAP P17). A ``cfg.cache_dtype`` cache (float8) is written
through ``common.to_cache_dtype_torch``, bit for bit the reference's cast,
and read by the decode kernel as it is stored.

On a mesh (DTensor params, the launcher's ``cfg.dp_axes``/``tp_axis``
set) q, k and v are constrained as the reference constrains them, each
device runs the kernel on its own batch and head shards
(``_sharded_heads_torch``, a ``local_map`` region), and a decode step runs
the decode kernel on each device's cache shard, merging a
sequence-sharded cache's chunks by their log-sum-exps (split-KV,
``_decode_sharded_torch``); a cache sharded on its head dim is attended in
plain torch on each device's slice of D, its partial scores summed across
the slices (``_decode_headdim_torch``).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Shard

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .common import (RMSNorm, apply_mrope, apply_rope, constrain_torch,
                     dense_init, local_region_torch, mm_promoted_torch,
                     placements_of_torch, shard_axes_torch,
                     to_cache_dtype_torch, unshard_dp_torch)
from .config import ModelConfig

NEG_INF = -1e30


def _param(t):
    return torch.nn.Parameter(t, requires_grad=False)


class Attention(torch.nn.Module):
    """Projections stored flattened, (d_model, H*hd), in the reference's
    (in, out) layout and applied as ``x @ W``."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device=None):
        super().__init__()
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
    q = mm_promoted_torch(x, unshard_dp_torch(p.wq, cfg))
    k = mm_promoted_torch(x, unshard_dp_torch(p.wk, cfg))
    v = mm_promoted_torch(x, unshard_dp_torch(p.wv, cfg))
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    heads = (1, 1, cfg.head_dim)      # shard whole heads, or replicate
    q = constrain_torch(q, cfg, "dp", None, "tp", granule=heads)
    k = constrain_torch(k, cfg, "dp", None, "tp", granule=heads)
    v = constrain_torch(v, cfg, "dp", None, "tp", granule=heads)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
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
    S, Hkv, D) -> (B, S, Hq, D), with a sliding window where ``window`` >
    0. The forward is the flash kernel with its log-sum-exp output (the
    plain version for CPU tensors) and saves (q, k, v, out, lse); the
    backward recomputes each kv block's probabilities from lse under the
    same mask, as the reference's ``bwd`` (``attention.py:208-254``), in
    float32: delta = sum(dO O), P = exp(S - lse), dV = P^T dO, dP = dO V^T,
    dS = P (dP - delta), dQ = dS K scale, dK = dS^T Q scale, cast back to
    the inputs' dtypes. Its live memory is O(S x block), not O(S^2)."""

    @staticmethod
    def forward(ctx, q, k, v, block, window=0):
        out, lse = flash_attention(q, k, v, causal=True, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block, ctx.window = block, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        block, window = ctx.block, ctx.window
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
            mask = kpos <= qpos
            if window:
                mask &= kpos > qpos - window
            s_blk = torch.where(mask, s_blk, NEG_INF)
            p_blk = torch.exp(s_blk - lse[..., None])       # (B,Hkv,rep,S,bk)
            dv[:, j0:j0 + block] = torch.einsum("bhrqk,bhrqd->bkhd", p_blk,
                                                dog)
            dp = torch.einsum("bhrqd,bkhd->bhrqk", dog, v_i)
            ds = p_blk * (dp - delta[..., None])
            dq += torch.einsum("bhrqk,bkhd->bqhrd", ds, k_i)
            dk[:, j0:j0 + block] = torch.einsum("bhrqk,bqhrd->bkhd", ds, qg)
        dq = (dq * scale).reshape(b, sq, hq, d).to(q.dtype)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


def _attend_any_torch(cfg: ModelConfig, q, k, v):
    """Causal (optionally sliding-window) attention for training, routed
    as the reference's ``_attend_any``: ``_FlashTrain`` where
    ``cfg.attn_flash_block`` divides S and S exceeds it, else ``_attend``
    (autograd through it)."""
    block = cfg.attn_flash_block
    if block and k.shape[1] % block == 0 and k.shape[1] > block:
        return _FlashTrain.apply(q, k, v, block, cfg.sliding_window)
    return _attend(cfg, q, k, v, 0)


def _sharded_heads_torch(name: str, cfg: ModelConfig, fn, q, k, v):
    """``fn(q, k, v)`` (a causal attention of (B, S, H, D) tensors); on
    DTensors, in ``local_region_torch``: batch over the dp axes, heads over
    the tp axis where the kv heads divide it, else (the q heads dividing
    it) with k and v repeated to the q heads first, as tensor-parallel
    GQA replicates kv heads; else heads replicated. Each device then runs
    the kernel (its plain version on CPU tensors) on its own shards."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    b, _, hq, _ = q.shape
    dp = shard_axes_torch(cfg, mesh, "dp", b)
    tp = shard_axes_torch(cfg, mesh, "tp", k.shape[2])
    if not tp and shard_axes_torch(cfg, mesh, "tp", hq):
        tp = shard_axes_torch(cfg, mesh, "tp", hq)
        rep = hq // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        name += " (kv heads repeated)"
    lay = (dp, (), tp, ())
    return local_region_torch(name, fn, (lay, lay, lay), (lay,), q, k, v)


def attention_train_torch(cfg: ModelConfig, p: Attention, x, positions):
    """Full-sequence causal attention with autograd (training); x: (B, S,
    D). The reference's ``attention_train``."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = _sharded_heads_torch(
        "attention_train", cfg,
        lambda q, k, v: _attend_any_torch(cfg, q, k, v), q, k, v)
    return mm_promoted_torch(out.reshape(out.shape[0], out.shape[1], -1),
                             unshard_dp_torch(p.wo, cfg))


def attention_prefill(cfg: ModelConfig, p: Attention, x, positions):
    """Full-sequence causal (optionally sliding-window) attention from
    position 0; x: (B, S, D). Returns (y, {"k", "v"}: this layer's (B, S,
    Hkv, D) cache in the compute dtype, as the reference's)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = _sharded_heads_torch(
        "flash_attention", cfg,
        lambda q, k, v: flash_attention(q, k, v, window=cfg.sliding_window),
        q, k, v)
    y = mm_promoted_torch(out.reshape(out.shape[0], out.shape[1], -1),
                          unshard_dp_torch(p.wo, cfg))
    return y, {"k": k, "v": v}


def _cache_axes_torch(cache_k):
    """(batch axes, sequence axes, head-dim axes) of a DTensor cache (B,
    S, Hkv, D). ``launch.sharding.cache_specs_np`` shards a cache on its
    batch and either its sequence (``decode_cache_shard="seq"``) or its
    head dim (``"headdim"``), never on its kv heads (the reference's
    ``cache_specs`` does not either: 8 or fewer kv heads do not divide the
    model axis), so a heads shard, or the sequence and the head dim at
    once, is refused."""
    mesh = cache_k.device_mesh
    axes = {0: (), 1: (), 3: ()}
    for name, pl in zip(mesh.mesh_dim_names, cache_k.placements):
        if isinstance(pl, Shard):
            if pl.dim not in axes:
                raise NotImplementedError(
                    f"a decode cache sharded on dim {pl.dim} (its kv heads): "
                    f"the sharded decode splits the batch and the sequence "
                    f"or the head dim, the layouts cache_specs_np gives "
                    f"(the reference never shards a cache's heads)")
            axes[pl.dim] += (name,)
    if axes[1] and axes[3]:
        raise NotImplementedError(
            "a decode cache sharded on both its sequence and its head dim: "
            "cache_specs_np gives one or the other (decode_cache_shard)")
    return axes[0], axes[1], axes[3]


def window_start_torch(cfg: ModelConfig, pos):
    """Each sequence's first row of the sliding window in a decode step,
    (B,) on pos's device, or None without a window: the reference's
    ``_attend`` with ``q_offset=pos_b.max()`` keeps rows > P - W, P the
    batch's largest position (not the sequence's own, ROADMAP P17)."""
    if not cfg.sliding_window:
        return None
    first = (pos.max() + (1 - cfg.sliding_window)).clamp_min(0)
    return first.expand(pos.shape[0])


def _valid_rows_torch(q, pos, kv_start, s_max: int):
    """(q, first row, length) of each sequence's decode over the whole
    cache: rows [kv_start, min(pos + 1, S_max)) (first None without a
    window). Where the window leaves a sequence no row, the reference's
    masked softmax (every score -1e30) weighs all S_max rows alike; a
    zeroed q over all of them gives the same, so that is what the kernel
    runs there (no host sync)."""
    length = (pos + 1).clamp(max=s_max)
    if kv_start is None:
        return q, None, length
    empty = kv_start >= length
    return (torch.where(empty[:, None, None, None], 0, q),
            torch.where(empty, 0, kv_start),
            torch.where(empty, s_max, length))


def _write_row_torch(caches, news, rows, idx, inside):
    """Writes each new (B, Hkv, D) row into its cache at ``idx`` where
    ``inside``, cast into the cache's dtype as the reference casts it."""
    for c, new in zip(caches, news):
        c[rows, idx] = torch.where(inside, to_cache_dtype_torch(new, c.dtype),
                                   c[rows, idx])


def _decode_rows_torch(q, k_new, v_new, ck, cv, pos, kv_start=None):
    """One decode step on whole cache rows: writes row ``pos`` of each
    sequence in place and runs the decode kernel (see
    ``attention_decode``). Returns (B, 1, Hq, D) in q's dtype."""
    b, s_max = ck.shape[0], ck.shape[1]
    inside = (pos < s_max)[:, None, None]
    rows = torch.arange(b, device=q.device)
    idx = pos.clamp(max=s_max - 1).long()
    _write_row_torch((ck, cv), (k_new[:, 0], v_new[:, 0]), rows, idx, inside)
    q, first, length = _valid_rows_torch(q, pos, kv_start, s_max)
    return decode_attention(q, ck, cv, length, kv_start=first)


def _decode_headdim_torch(q, k_new, v_new, cache, pos, kv_start, dp, hd):
    """The decode step on a cache sharded on its head dim over the mesh
    axes ``hd`` (``decode_cache_shard="headdim"``), in one
    ``local_region_torch``: each device holds every row of its batch
    shard at a slice of D. It writes the new row into its slice, forms the
    partial scores q[..., slice] . k[..., slice] in float32, sums them
    over the ``hd`` axes (one all-reduce of (B, Hq, S_max) float32 scores
    a layer: the reference's "per-layer scores all-reduce",
    ``repro/launch/sharding.py:38``), masks the rows outside [kv_start,
    min(pos + 1, S_max)) and takes the softmax, then p . v[..., slice]:
    the output comes out sharded on D as the cache is, and is gathered
    over ``hd`` (one cache row's size) before ``wo``.

    Gathering D of the cache instead would move the K and V rows to every
    device every step: Hkv x D / Hq times the scores' bytes in bf16 (64x
    at qwen3_1_7b's 16/8 x 128). The decode kernel takes whole rows of D,
    so it does not run here: the region is plain torch, as the
    reference's ``_attend`` is jnp (the plain version's arithmetic,
    ``kernels/decode_attention/ref.py``). Returns (B, 1, Hq, D) in q's
    dtype."""
    mesh = cache["k"].device_mesh
    groups = [mesh.get_group(a) for a in hd]
    s_max, d_full = cache["k"].shape[1], cache["k"].shape[3]
    scale = 1.0 / math.sqrt(d_full)

    def part(q, k_new, v_new, ck, cv, pos, kv_start):
        from torch.distributed import _functional_collectives as funcol
        b, _, hq, d = q.shape
        hkv = ck.shape[2]
        rows = torch.arange(b, device=q.device)
        inside = (pos < s_max)[:, None, None]
        idx = pos.clamp(max=s_max - 1).long()
        _write_row_torch((ck, cv), (k_new[:, 0], v_new[:, 0]), rows, idx,
                         inside)
        q, first, length = _valid_rows_torch(q, pos, kv_start, s_max)
        qg = q.float().reshape(b, hkv, hq // hkv, d) * scale
        scores = torch.einsum("bhrd,bkhd->bhrk", qg, ck.float())
        for group in groups:
            scores = funcol.wait_tensor(funcol.all_reduce(scores, "sum",
                                                          group))
        first = torch.zeros_like(length) if first is None else first
        k_rows = torch.arange(s_max, device=q.device)[None, :]
        valid = (k_rows >= first[:, None]) & (k_rows < length[:, None])
        probs = torch.softmax(scores.masked_fill(
            ~valid[:, None, None, :], float("-inf")), dim=-1)
        out = torch.einsum("bhrk,bkhd->bhrd", probs, cv.float())
        return out.reshape(b, 1, hq, d).to(q.dtype)

    sliced = (dp, (), (), hd)
    per_seq = ((dp,), None if kv_start is None else (dp,))
    out = local_region_torch(
        "decode_attention (head-dim shards)", part, (sliced,) * 5 + per_seq,
        (sliced,), q, k_new, v_new, cache["k"], cache["v"], pos, kv_start)
    # (B, 1, Hq, D), one cache row's size: gathered over the head-dim axes
    # before its heads are flattened into wo's rows (a view cannot flatten
    # a sharded D, and torch 2.11's DTensor will not redistribute for it)
    return out.redistribute(mesh, placements_of_torch(mesh,
                                                      (dp, (), (), ())))


def _decode_sharded_torch(q, k_new, v_new, cache, pos, kv_start):
    """The decode step on a DTensor cache. Sharded on batch only, each
    device runs ``_decode_rows_torch`` on its own sequences. Sharded on
    the head dim, ``_decode_headdim_torch``. Sharded on
    the sequence too (split-KV, flash-decoding), each device writes the new
    row where it falls in its chunk and runs the decode kernel on its chunk
    (``_decode_chunk_torch``), which also gives each head's log-sum-exp;
    the chunks' outputs are then merged by their log-sum-exps with DTensor
    reductions over the sequence axes. ``kv_start`` (the window's first
    rows, from the whole batch's positions) is split on the batch as pos
    is. Returns (B, 1, Hq, D) in q's dtype."""
    mesh = cache["k"].device_mesh
    dp, seq, hd = _cache_axes_torch(cache["k"])
    if hd:
        return _decode_headdim_torch(q, k_new, v_new, cache, pos, kv_start,
                                     dp, hd)
    row = (dp, (), (), ())
    per_seq = ((dp,), None if kv_start is None else (dp,))
    if not seq:
        return local_region_torch(
            "decode_attention", _decode_rows_torch, (row,) * 5 + per_seq,
            (row,), q, k_new, v_new, cache["k"], cache["v"], pos, kv_start)
    s_max = cache["k"].shape[1]
    n_chunks = 1
    for a in seq:
        n_chunks *= mesh.size(mesh.mesh_dim_names.index(a))
    chunk = s_max // n_chunks

    def part(q, k_new, v_new, ck, cv, pos, kv_start):
        coord = mesh.get_coordinate() or [0] * mesh.ndim
        idx = 0
        for a in seq:
            i = mesh.mesh_dim_names.index(a)
            idx = idx * mesh.size(i) + coord[i]
        return _decode_chunk_torch(q, k_new, v_new, ck, cv, pos, idx * chunk,
                                   s_max, kv_start)

    kv = (dp, seq, (), ())
    o, lse = local_region_torch(
        "decode_attention (split-KV)", part, (row, row, row, kv, kv) + per_seq,
        ((seq, dp, (), (), ()), (seq, dp, ())),
        q, k_new, v_new, cache["k"], cache["v"], pos, kv_start)
    return merge_chunks_torch(o, lse).to(q.dtype)


def _decode_chunk_torch(q, k_new, v_new, ck, cv, pos, c0: int, s_max: int,
                        kv_start=None):
    """One device's part of the split-KV decode on local tensors: q (B, 1,
    Hq, D), the new rows (B, 1, Hkv, D), its cache chunk (B, C, Hkv, D)
    holding rows [c0, c0 + C), pos (B,), kv_start (B,) or None. Writes row
    ``pos`` where it falls in the chunk (a row past the cache is written
    nowhere, as on one card) and runs the decode kernel over the chunk's
    share of the valid rows [kv_start, min(pos + 1, S_max)), translated to
    its own rows. Returns (out (1, B, 1, Hq, D), lse (1, B, Hq))."""
    b, c = ck.shape[0], ck.shape[1]
    rows = torch.arange(b, device=q.device)
    local = pos.long() - c0
    inside = ((local >= 0) & (local < c) & (pos < s_max))[:, None, None]
    idx = local.clamp(0, c - 1)
    _write_row_torch((ck, cv), (k_new[:, 0], v_new[:, 0]), rows, idx, inside)
    q, first, length = _valid_rows_torch(q, pos, kv_start, s_max)
    start = None if first is None else (first - c0).clamp(0, c)
    out, lse = decode_attention(q, ck, cv, (length - c0).clamp(0, c),
                                kv_start=start, return_lse=True)
    return out[None], lse[None]


def merge_chunks_torch(o, lse):
    """Attention over the union of K chunks from each chunk's output o (K,
    B, 1, Hq, D) and log-sum-exp lse (K, B, Hq): the outputs weighed by
    exp(lse - max lse), in float32 (a chunk with no valid row, lse -inf,
    weighs 0; a sequence with none anywhere gives 0)."""
    m_all = lse.amax(dim=0)
    w = torch.exp(lse - m_all)
    w = torch.where(torch.isfinite(lse), w, 0.0)
    l_all = w.sum(dim=0)
    o_all = (o.float() * w[:, :, None, :, None]).sum(dim=0)
    return torch.where(l_all[:, None, :, None] > 0,
                       o_all / l_all.clamp_min(1e-30)[:, None, :, None], 0.0)


def attention_decode(cfg: ModelConfig, p: Attention, x, cache: dict, pos):
    """One-token decode. x: (B, 1, D); cache k/v: (B, S_max, Hkv, D),
    written IN PLACE at each sequence's ``pos`` (the reference rebuilds its
    immutable cache); pos: (B,) int tensor on x's device.

    As the reference's masked-select write, a sequence whose ``pos`` is
    past the cache writes nothing and attends its whole row: the write
    index is clamped and the old row kept there (``torch.where``), and the
    kernel's length is ``min(pos + 1, S_max)``; with a sliding window its
    first row is ``window_start_torch``'s — all on the device, no host
    sync. The new rows are cast into the cache's dtype as the reference
    casts them (``to_cache_dtype_torch``). Returns (y, cache)."""
    b = x.shape[0]
    positions = pos[:, None]
    if cfg.rope_type == "mrope":        # (3, B, 1): t == h == w
        positions = positions[None].expand(3, b, 1)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    kv_start = window_start_torch(cfg, pos)
    if isinstance(cache["k"], DTensor):
        out = _decode_sharded_torch(q, k_new, v_new, cache, pos, kv_start)
    else:
        out = _decode_rows_torch(q, k_new, v_new, cache["k"], cache["v"],
                                 pos, kv_start)
    y = mm_promoted_torch(out.reshape(b, 1, -1), unshard_dp_torch(p.wo, cfg))
    return y, cache
