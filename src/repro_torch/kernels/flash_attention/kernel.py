"""``flash_attention``: the wrapper of the Hopper ``flash_attention``
kernel.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/flash_attention/kernel.py::_flash_kernel``. It is built
with ``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA
tensor; CPU tensors take the plain version in ``ref.py``, and nothing else
does.

It has two bodies, chosen from the inputs (:func:`takes_hopper_body`):
bfloat16 with head dim 64 or 128 on rows TMA can address runs the Hopper
body (TMA loads, ``wgmma`` products, kv tiles of ``KV_ROWS`` rows, blocks
of :func:`block_rows` query rows);
everything else runs the CUDA-core body. ``flash_attention.launches``
counts every launch, ``flash_attention.hopper_launches`` and
``flash_attention.cuda_core_launches`` each body's.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import ref

#: head dims the kernel takes (multiples of 8 up to this), and those of
#: the Hopper body
MAX_HEAD_DIM = 128
HOPPER_HEAD_DIMS = (64, 128)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
#: the query rows a block of the Hopper body is compiled for (64 per
#: consumer warpgroup), and its kv rows a pipeline stage
BLOCK_ROWS = (64, 128)
KV_ROWS = 128
#: the card's SMs
SMS = 132


def block_rows(batch: int, seq: int, hq: int) -> int:
    """Query rows a block of the Hopper body: 64 while all the blocks run
    at once, one an SM; past that, 128 (two warpgroups), which halves the
    blocks. ``chip_smoke.py``'s "flash tile plans" phase times both at the
    serving path's lengths."""
    return 64 if batch * hq * -(-seq // 64) <= SMS else 128


def _strides(t):
    """(batch, seq, head) strides of a (B, S, H, D) tensor, a size-1 dim's
    stride (which addresses nothing) replaced by the packed one."""
    _, s, h, d = t.shape
    packed = (s * h * d, h * d, d)
    return [st if n > 1 else p
            for st, n, p in zip(t.stride()[:3], t.shape[:3], packed)]


def takes_hopper_body(q, k, v) -> bool:
    """Whether these inputs (already validated by the wrapper) run the
    Hopper body: bfloat16, head dim 64 or 128, 16-byte-aligned pointers
    and strides that are multiples of 8 elements (what TMA addresses)."""
    return (q.dtype == torch.bfloat16
            and q.shape[3] in HOPPER_HEAD_DIMS
            and all(t.data_ptr() % 16 == 0 and all(
                st % 8 == 0 and st > 0 for st in _strides(t))
                for t in (q, k, v)))


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
        st for t in (q, k, v, out) for st in _strides(t)))
    hopper = takes_hopper_body(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, s, hq, hkv, d, float(sm_scale),
                int(bool(causal)))
        if hopper:
            err = _entry("flash_attention_bf16_hopper")(
                *args, block_rows(b, s, hq), stream)
        else:
            err = _entry(_ENTRY[q.dtype])(*args, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    if hopper:
        flash_attention.hopper_launches += 1
    else:
        flash_attention.cuda_core_launches += 1
    return out


flash_attention.launches = 0
flash_attention.hopper_launches = 0
flash_attention.cuda_core_launches = 0


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int] \
        + [ctypes.c_int] * (1 if name.endswith("hopper") else 0) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
