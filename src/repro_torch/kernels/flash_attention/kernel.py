"""``flash_attention``: the wrapper of the Hopper ``flash_attention``
kernel.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/flash_attention/kernel.py::_flash_kernel``. It is built
with ``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA
tensor; CPU tensors take the plain version in ``ref.py``, and nothing else
does. ``flash_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import ref

#: head dims the kernel takes: multiples of 8 up to this
MAX_HEAD_DIM = 128
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D), one dtype (float32 or
    bfloat16), one device, each with a contiguous head dim (other strides
    free). Returns a contiguous (B, S, Hq, D) tensor of q's dtype."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu: {q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, S, Hq, D): "
                         f"{tuple(q.shape)}")
    b, s, hq, d = q.shape
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16: "
                        f"{q.dtype}")
    if k.dim() != 4 or k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(f"flash_attention: k must be (B, S, Hkv, D) = "
                         f"({b}, {s}, Hkv, {d}): {tuple(k.shape)}")
    hkv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"head dim (stride 1): strides {t.stride()}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: v {tuple(v.shape)} != k "
                         f"{tuple(k.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq {hq} is not a multiple of "
                         f"Hkv {hkv}")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims that are "
                         f"multiples of 8 up to {MAX_HEAD_DIM}: {d}")
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (q, k, v, out) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _entry(_ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, s, hq, hkv, d, float(sm_scale), int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
