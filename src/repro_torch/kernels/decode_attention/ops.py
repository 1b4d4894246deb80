"""``decode_attention`` in the model's layout: the port of
``repro/kernels/decode_attention/ops.py``. The reference groups q and
transposes the whole cache to (B, Hkv, S, D) on every call; the port's
kernel reads the cache in its native (B, S_max, Hkv, D) layout through
strides, so a step reads only each sequence's valid prefix, once."""
from __future__ import annotations

import torch

from .kernel import decode_attention as _kernel


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     sm_scale: float | None = None):
    """q: (B, 1, Hq, D); k_cache, v_cache: (B, S_max, Hkv, D); kv_len: (B,)
    or () int tensor (valid cache rows per sequence, on q's device).
    Returns (B, 1, Hq, D) in q's dtype; the caches must share it."""
    b = q.shape[0]
    kv_len = torch.as_tensor(kv_len, device=q.device).to(torch.int32)
    kv_len = kv_len.expand(b).contiguous()
    out = _kernel(q[:, 0], k_cache, v_cache, kv_len, sm_scale=sm_scale)
    return out[:, None]
