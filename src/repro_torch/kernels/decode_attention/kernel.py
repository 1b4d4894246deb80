"""``decode_attention``: the wrapper of the Hopper ``decode_attention``
kernel.

The kernel (``csrc/decode_attention.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/decode_attention/kernel.py::_decode_kernel``. It is built
with ``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA
tensor; CPU tensors take the plain version in ``ref.py``, and nothing else
does. ``decode_attention.launches`` counts the kernel's launches,
``decode_attention.window_launches`` those given a first valid row per
sequence (``kv_start``, the model's sliding window),
``decode_attention.fp8_launches`` those over float8 caches and
``decode_attention.mixed_launches`` those of a float32 q over bfloat16
caches.

The caches are in q's dtype, or both ``float8_e4m3fn`` or both
``float8_e5m2`` under a bfloat16 or float32 q (the reference's quantized
KV cache), or both bfloat16 under a float32 q (float32 params over
bfloat16 activations: q comes out of the projections float32, the cache
is kept in the compute dtype): the kernel reads the stored bytes and
widens them in registers, exactly, as the reference dequantises by a
plain cast. Any other mix raises; nothing is cast before the kernel.

On CPU tensors the plain version runs as one operator,
``torch.ops.repro_torch.decode_attention_plain`` (``_plain_torch``), with a
fake implementation and a FLOP formula: a trace under a ``FakeTensorMode``
(``launch/dryrun.py``) sees the kernel's inputs, outputs and operations,
not the plain version's float32 copies of the cache. The lengths are data
a trace cannot read, so it counts the whole cache.

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

from torch.utils.flop_counter import register_flop_formula

from .. import _build
from . import ref

#: head dims the kernel takes (multiples of 8 up to this), and the most
#: query heads that may share one kv head
MAX_HEAD_DIM = 256
MAX_GROUP = 16
#: (q dtype, cache dtype) -> the kernel's entry
_ENTRY = {(torch.float32, torch.float32): "decode_attention_f32",
          (torch.bfloat16, torch.bfloat16): "decode_attention_bf16",
          (torch.bfloat16, torch.float8_e4m3fn): "decode_attention_bf16_e4m3",
          (torch.bfloat16, torch.float8_e5m2): "decode_attention_bf16_e5m2",
          (torch.float32, torch.float8_e4m3fn): "decode_attention_f32_e4m3",
          (torch.float32, torch.float8_e5m2): "decode_attention_f32_e5m2",
          (torch.float32, torch.bfloat16): "decode_attention_f32_bf16"}
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
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


def decode_attention(q, k_cache, v_cache, kv_len, *, kv_start=None,
                     sm_scale: float | None = None, return_lse: bool = False):
    """q: (B, Hq, D), float32 or bfloat16; k_cache, v_cache: (B, S_max,
    Hkv, D), both of q's dtype, both one float8 dtype or, under a float32
    q, both bfloat16, each with a
    contiguous head dim (other strides free); kv_len and (optionally)
    kv_start: (B,) int32, contiguous, on the same device, read there (no
    host sync). Sequence b attends rows [F_b, L_b): L_b = kv_len[b] clamped
    to [0, S_max], F_b = kv_start[b] (0 without it) clamped to [0, L_b].
    Returns a contiguous (B, Hq, D) tensor of q's dtype; with
    ``return_lse`` also each head's log-sum-exp of its scaled scores over
    the valid rows, a contiguous float32 (B, Hq) tensor (-inf where no row
    is valid, whose output is 0)."""
    if q.device.type == "cpu":
        outs = _plain_torch(q, k_cache, v_cache, kv_len, kv_start, sm_scale,
                            return_lse)
        return tuple(outs) if return_lse else outs[0]
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu: {q.device}")
    if q.dim() != 3:
        raise ValueError(f"decode_attention: q must be (B, Hq, D): "
                         f"{tuple(q.shape)}")
    b, hq, d = q.shape
    entry = _ENTRY.get((q.dtype, k_cache.dtype))
    if entry is None or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention takes a float32 or bfloat16 q "
                        f"with caches of its dtype, both float8 (e4m3fn or "
                        f"e5m2) or, under a float32 q, both bfloat16: q "
                        f"{q.dtype}, k_cache "
                        f"{k_cache.dtype}, v_cache {v_cache.dtype}")
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"decode_attention: k_cache must be (B, S_max, Hkv,"
                         f" D) = ({b}, S_max, Hkv, {d}): "
                         f"{tuple(k_cache.shape)}")
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} needs a contiguous "
                             f"head dim (stride 1): strides {t.stride()}")
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"decode_attention: v_cache {tuple(v_cache.shape)}"
                         f" != k_cache {tuple(k_cache.shape)}")
    for name, t in (("kv_len", kv_len), ("kv_start", kv_start)):
        if t is not None and (t.device != q.device or t.dtype != torch.int32
                              or tuple(t.shape) != (b,)
                              or not t.is_contiguous()):
            raise ValueError(f"decode_attention: {name} must be a "
                             f"contiguous int32 tensor of shape ({b},) on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: Hq {hq} must be a multiple of "
                         f"Hkv {hkv} at most {MAX_GROUP} times it")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention takes head dims that are "
                         f"multiples of 8 up to {MAX_HEAD_DIM}: {d}")
    if s_max == 0:
        raise ValueError("decode_attention needs a cache of at least one row")
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or hq == 0:
        return (out, lse) if return_lse else out
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
        err = _entry(entry)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_len.data_ptr(),
            kv_start.data_ptr() if kv_start is not None else None,
            out.data_ptr(),
            lse.data_ptr() if return_lse else None, part.data_ptr(), strides,
            b, s_max, hq, hkv, d, float(sm_scale), chunk,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    if kv_start is not None:
        decode_attention.window_launches += 1
    if k_cache.dtype in FP8:
        decode_attention.fp8_launches += 1
    if k_cache.dtype != q.dtype and k_cache.dtype not in FP8:
        decode_attention.mixed_launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
decode_attention.window_launches = 0
decode_attention.fp8_launches = 0
decode_attention.mixed_launches = 0


@torch.library.custom_op(
    "repro_torch::decode_attention_plain", mutates_args=(),
    schema="(Tensor q, Tensor k_cache, Tensor v_cache, Tensor kv_len, "
           "Tensor? kv_start, float? sm_scale, bool return_lse) -> Tensor[]")
def _plain_torch(q, k_cache, v_cache, kv_len, kv_start, sm_scale,
                 return_lse):
    """The plain version (``ref.py``) as one operator: [out] or [out,
    lse]."""
    outs = ref.decode_attention(q, k_cache, v_cache, kv_len,
                                kv_start=kv_start, sm_scale=sm_scale,
                                return_lse=return_lse)
    return list(outs) if return_lse else [outs]


@_plain_torch.register_fake
def _plain_fake_torch(q, k_cache, v_cache, kv_len, kv_start, sm_scale,
                      return_lse):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if not return_lse:
        return [out]
    return [out, torch.empty(q.shape[:2], dtype=torch.float32,
                             device=q.device)]


@register_flop_formula(torch.ops.repro_torch.decode_attention_plain)
def _plain_flops_np(q_shape, k_shape, *args, **kwargs) -> int:
    """The kernel's operations over the whole cache: q.k and p.v, 4 D a
    (query head, row); the lengths and first rows are data a trace cannot
    read."""
    b, hq, d = q_shape
    return 4 * b * hq * d * k_shape[1]


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("decode_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
