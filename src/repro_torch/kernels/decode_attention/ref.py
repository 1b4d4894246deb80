"""Plain PyTorch version of the ``decode_attention`` kernel: one query
token per sequence attends rows [kv_start[b], kv_len[b]) of its cache
(kv_len clamped to [0, S_max], kv_start to [0, kv_len], 0 without it), in
float32 with the output cast to q's dtype — what
``repro/kernels/decode_attention/kernel.py::_decode_kernel`` computes for a
scalar length, with one length (and first row: the model's sliding window)
per sequence. No valid row gives zeros, as the kernel does. A float8 cache
is read through ``.float()``, exactly, as the reference's model
dequantises it, and so is a bfloat16 cache under a float32 q. The
wrapper uses it for CPU tensors; ``chip_smoke.py`` holds the kernel
against it."""
from __future__ import annotations

import math

import torch


def decode_attention(q, k_cache, v_cache, kv_len, *, kv_start=None,
                     sm_scale: float | None = None, return_lse: bool = False):
    """q: (B, Hq, D); k_cache, v_cache: (B, S_max, Hkv, D); kv_len and
    kv_start: (B,) int. Returns (B, Hq, D); query head h reads kv head h //
    (Hq // Hkv). With ``return_lse`` also each head's log-sum-exp of its
    scaled, masked scores, float32 (B, Hq) (-inf where no row is
    valid)."""
    b, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, rep, d) * sm_scale
    scores = torch.einsum("bhrd,bkhd->bhrk", qg, k_cache.float())
    length = kv_len.to(device=q.device, dtype=torch.long).clamp(0, s_max)
    first = torch.zeros_like(length) if kv_start is None else torch.minimum(
        kv_start.to(device=q.device, dtype=torch.long).clamp_min(0), length)
    rows = torch.arange(s_max, device=q.device)[None, :]
    valid = (rows >= first[:, None]) & (rows < length[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = probs.masked_fill((first == length)[:, None, None, None], 0.0)
    out = torch.einsum("bhrk,bkhd->bhrd", probs, v_cache.float())
    out = out.reshape(b, hq, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).reshape(b, hq)
    return out
