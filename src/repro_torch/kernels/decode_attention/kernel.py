"""``decode_attention``: the wrapper of the Hopper ``decode_attention``
kernel.

The kernel (``csrc/decode_attention.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/decode_attention/kernel.py::_decode_kernel``. It is built
with ``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA
tensor; CPU tensors take the plain version in ``ref.py``, and nothing else
does. ``decode_attention.launches`` counts the kernel's launches.

Split-KV: every (sequence, kv head)'s cache rows are cut into chunks of
:func:`chunk_rows` rows, one block each, whose float32 partials (max, sum,
accumulator) a second kernel merges by their log-sum-exp; the wrapper
allocates that scratch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import ref

#: head dims the kernel takes (multiples of 8 up to this), and the most
#: query heads that may share one kv head
MAX_HEAD_DIM = 128
MAX_GROUP = 16
_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
#: blocks the split grid aims at (4 per SM of an H100, about as many as
#: are resident at once), and its chunks' least rows
TARGET_BLOCKS = 4 * 132
MIN_CHUNK = 64


def chunk_rows(batch: int, s_max: int, hkv: int) -> int:
    """Rows per split block: the least power of two >= ``MIN_CHUNK`` that
    keeps the grid of B x Hkv x ceil(S_max / chunk) blocks within
    ``TARGET_BLOCKS``. The grid is sized from S_max, since the lengths stay
    on the device; blocks past a sequence's length exit at once."""
    chunk = MIN_CHUNK
    while batch * hkv * -(-s_max // chunk) > TARGET_BLOCKS:
        chunk *= 2
    return chunk


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     sm_scale: float | None = None):
    """q: (B, Hq, D); k_cache, v_cache: (B, S_max, Hkv, D), one dtype
    (float32 or bfloat16) with q, each with a contiguous head dim (other
    strides free); kv_len: (B,) int32, contiguous, on the same device, read
    there (no host sync) and clamped to [0, S_max]. Returns a contiguous
    (B, Hq, D) tensor of q's dtype."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, kv_len,
                                    sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu: {q.device}")
    if q.dim() != 3:
        raise ValueError(f"decode_attention: q must be (B, Hq, D): "
                         f"{tuple(q.shape)}")
    b, hq, d = q.shape
    if q.dtype not in _ENTRY:
        raise TypeError(f"decode_attention takes float32 or bfloat16: "
                        f"{q.dtype}")
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"decode_attention: k_cache must be (B, S_max, Hkv,"
                         f" D) = ({b}, S_max, Hkv, {d}): "
                         f"{tuple(k_cache.shape)}")
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} needs a contiguous "
                             f"head dim (stride 1): strides {t.stride()}")
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"decode_attention: v_cache {tuple(v_cache.shape)}"
                         f" != k_cache {tuple(k_cache.shape)}")
    if kv_len.device != q.device or kv_len.dtype != torch.int32 \
            or tuple(kv_len.shape) != (b,) or not kv_len.is_contiguous():
        raise ValueError(f"decode_attention: kv_len must be a contiguous "
                         f"int32 tensor of shape ({b},) on {q.device}, got "
                         f"{kv_len.dtype} {tuple(kv_len.shape)} on "
                         f"{kv_len.device}")
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: Hq {hq} must be a multiple of "
                         f"Hkv {hkv} at most {MAX_GROUP} times it")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention takes head dims that are "
                         f"multiples of 8 up to {MAX_HEAD_DIM}: {d}")
    if s_max == 0:
        raise ValueError("decode_attention needs a cache of at least one row")
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if b == 0 or hq == 0:
        return out
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    chunk = chunk_rows(b, s_max, hkv)
    # per (sequence, kv head, chunk, query head): max, sum, accumulator
    part = torch.empty((b * -(-s_max // chunk) * hq * (d + 2),),
                       dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:2])
    with torch.cuda.device(q.device):
        err = _entry(_ENTRY[q.dtype])(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), part.data_ptr(), strides, b,
            s_max, hq, hkv, d, float(sm_scale), chunk,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("decode_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
