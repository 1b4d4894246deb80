"""Plain PyTorch version of the ``decode_attention`` kernel: one query
token per sequence attends the first ``kv_len[b]`` rows of its cache
(clamped to [0, S_max]), in float32 with the output cast to q's dtype —
what ``repro/kernels/decode_attention/kernel.py::_decode_kernel`` computes
for a scalar length, with one length per sequence. A length of 0 gives
zeros, as the kernel does. The wrapper uses it for CPU tensors;
``chip_smoke.py`` holds the kernel against it."""
from __future__ import annotations

import math

import torch


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     sm_scale: float | None = None):
    """q: (B, Hq, D); k_cache, v_cache: (B, S_max, Hkv, D); kv_len: (B,)
    int. Returns (B, Hq, D); query head h reads kv head h // (Hq // Hkv)."""
    b, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, rep, d) * sm_scale
    scores = torch.einsum("bhrd,bkhd->bhrk", qg, k_cache.float())
    length = kv_len.to(device=q.device, dtype=torch.long).clamp(0, s_max)
    valid = torch.arange(s_max, device=q.device)[None, :] < length[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = probs.masked_fill((length == 0)[:, None, None, None], 0.0)
    out = torch.einsum("bhrk,bkhd->bhrd", probs, v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)
