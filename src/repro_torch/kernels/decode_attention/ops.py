"""``decode_attention`` in the model's layout: the port of
``repro/kernels/decode_attention/ops.py``. The reference groups q and
transposes the whole cache to (B, Hkv, S, D) on every call; the port's
kernel reads the cache in its native (B, S_max, Hkv, D) layout through
strides, so a step reads only each sequence's valid prefix, once."""
from __future__ import annotations

import torch

from .kernel import decode_attention as _kernel


def _per_sequence(n, b, device):
    return torch.as_tensor(n, device=device).to(torch.int32).expand(
        b).contiguous()


def decode_attention(q, k_cache, v_cache, kv_len, *, kv_start=None,
                     sm_scale: float | None = None, return_lse: bool = False):
    """q: (B, 1, Hq, D); k_cache, v_cache: (B, S_max, Hkv, D); kv_len and
    (optionally) kv_start: (B,) or () int tensors (each sequence's valid
    cache rows are [kv_start, kv_len), on q's device). Returns (B, 1, Hq,
    D) in q's dtype; the caches share it or are both float8. With
    ``return_lse`` also the heads' log-sum-exps, float32 (B, Hq)."""
    b = q.shape[0]
    kv_len = _per_sequence(kv_len, b, q.device)
    if kv_start is not None:
        kv_start = _per_sequence(kv_start, b, q.device)
    if return_lse:
        out, lse = _kernel(q[:, 0], k_cache, v_cache, kv_len,
                           kv_start=kv_start, sm_scale=sm_scale,
                           return_lse=True)
        return out[:, None], lse
    out = _kernel(q[:, 0], k_cache, v_cache, kv_len, kv_start=kv_start,
                  sm_scale=sm_scale)
    return out[:, None]
