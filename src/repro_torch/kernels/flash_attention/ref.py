"""Plain PyTorch version of the ``flash_attention`` kernel: causal (or
full) grouped-query attention in float32 with the output cast to q's
dtype — what ``repro/kernels/flash_attention/kernel.py::_flash_kernel``
and its oracle ``ref.py::attention_ref`` compute, in the model's
(B, S, H, D) layout, with the reference model's sliding window on request
(``repro/models/attention.py:88-89``), and each row's log-sum-exp, as the
reference's training flash ``repro/models/attention.py::_flash_fwd_scan``
returns it. The wrapper uses it for CPU tensors;
``chip_smoke.py`` holds the kernel against it."""
from __future__ import annotations

import math

import torch


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale: float | None = None, return_lse: bool = False):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D); query head
    h reads kv head h // (Hq // Hkv); with ``window`` W > 0 (causal) row i
    attends keys i - W < j <= i. With ``return_lse`` also each row's
    log-sum-exp of its scaled, masked scores, float32 (B, Hq, S)."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * sm_scale, kf)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        if window > 0:
            mask = mask.triu(1 - window)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out
