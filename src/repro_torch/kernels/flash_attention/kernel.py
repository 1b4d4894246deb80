"""``flash_attention``: the wrapper of the Hopper ``flash_attention``
kernel.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/flash_attention/kernel.py::_flash_kernel``. It is built
with ``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA
tensor; CPU tensors take the plain version in ``ref.py``, and nothing else
does.

It has three bodies, chosen from the inputs (:func:`takes_hopper_body`,
:func:`takes_tf32_body`): bfloat16 with head dim 64, 128 or 256 on rows
TMA can address runs the Hopper body (TMA loads, ``wgmma`` products; at
head dims 64 and 128 kv tiles of ``KV_ROWS`` rows and blocks of
:func:`block_rows` query rows, at gemma_2b's 256 kv tiles of
``KV_ROWS_D256`` rows and blocks of ``BLOCK_ROWS_D256``); float32 with head
dim 64, 128 or 256 on rows ``cp.async`` copies 16 bytes at a time runs the
float32 tensor-core body (``mma.sync`` in split TF32: each operand as two
TF32 terms, three products for one, float32 sums); float32 and bfloat16
otherwise run the CUDA-core body. ``flash_attention.launches`` counts
every launch, ``flash_attention.hopper_launches``,
``flash_attention.tf32_launches`` and ``flash_attention.cuda_core_launches``
each body's, ``flash_attention.lse_launches`` those that also wrote the
rows' log-sum-exp (``return_lse=True``, the training path's forward),
``flash_attention.window_launches`` those with a sliding window
(``window=W > 0``: row i attends keys i - W < j <= i; both bodies skip the
kv tiles wholly below a block's window).

On CPU tensors the plain version runs as one operator,
``torch.ops.repro_torch.flash_attention_plain`` (``_plain_torch``), with a
fake implementation and a FLOP formula: a trace under a ``FakeTensorMode``
(``launch/dryrun.py``) sees the kernel's inputs, outputs and operations
(the causal half of the products, or the windowed pairs), not the plain
version's S x S scores.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from torch.utils.flop_counter import register_flop_formula

from .. import _build
from . import ref

#: head dims the kernel takes (multiples of 8 up to this), and those of
#: the Hopper body and of the float32 tensor-core body
MAX_HEAD_DIM = 256
HOPPER_HEAD_DIMS = (64, 128, 256)
TF32_HEAD_DIMS = (64, 128, 256)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
#: the query rows a block of the Hopper body is compiled for (64 per
#: consumer warpgroup), and its kv rows a pipeline stage
BLOCK_ROWS = (64, 128)
KV_ROWS = 128
#: the Hopper body at head dim 256: its kv rows a pipeline stage (a stage
#: of 128 rows of K and V would be 128 KB) and its query rows a block, one
#: consumer warpgroup with a 64 x 256 float32 accumulator (198 registers a
#: thread; two warpgroups a block would get 168 and spilled, and ran
#: slower at gemma_2b's heads at every S tried: PERF.md)
KV_ROWS_D256 = 64
BLOCK_ROWS_D256 = 64
#: the float32 tensor-core body's plan (``flash_tf32_kernel``): query
#: rows a block (16 a warp, 4 warps) and kv rows a tile by head dim (one
#: 32-row stage at 256, for the shared memory; two 64-row stages below)
TF32_BLOCK_ROWS = 64
TF32_KV_ROWS = {64: 64, 128: 64, 256: 32}
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
    Hopper body: bfloat16, head dim 64, 128 or 256, 16-byte-aligned pointers
    and strides that are multiples of 8 elements (what TMA addresses)."""
    return (q.dtype == torch.bfloat16
            and q.shape[3] in HOPPER_HEAD_DIMS
            and all(t.data_ptr() % 16 == 0 and all(
                st % 8 == 0 and st > 0 for st in _strides(t))
                for t in (q, k, v)))


def takes_tf32_body(q, k, v) -> bool:
    """Whether these inputs (already validated by the wrapper) run the
    float32 tensor-core body: float32, head dim 64, 128 or 256,
    16-byte-aligned pointers and strides that are multiples of 4 elements
    (what ``cp.async`` copies 16 bytes at a time)."""
    return (q.dtype == torch.float32
            and q.shape[3] in TF32_HEAD_DIMS
            and all(t.data_ptr() % 16 == 0 and all(
                st % 4 == 0 and st > 0 for st in _strides(t))
                for t in (q, k, v)))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale: float | None = None, return_lse: bool = False):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D), one dtype (float32 or
    bfloat16), one device, each with a contiguous head dim (other strides
    free). ``window`` W > 0 (causal only) keeps keys i - W < j <= i for
    query row i, as the reference's ``sliding_window``; 0 keeps them all.
    Returns a contiguous (B, S, Hq, D) tensor of q's dtype; with
    ``return_lse`` also each row's log-sum-exp of its scaled, masked
    scores, a contiguous float32 (B, Hq, S) tensor (``m + log(l)``, as the
    reference's ``_flash_fwd_scan`` returns it)."""
    window = int(window)
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention: a window must be >= 0 and "
                         f"needs causal=True: window={window}, "
                         f"causal={causal}")
    if q.device.type == "cpu":
        outs = _plain_torch(q, k, v, causal, window, sm_scale, return_lse)
        return tuple(outs) if return_lse else outs[0]
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
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (q, k, v, out) for st in _strides(t)))
    hopper = takes_hopper_body(q, k, v)
    tf32 = not hopper and takes_tf32_body(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if return_lse else None, strides, b, s, hq,
                hkv, d, float(sm_scale), int(bool(causal)), window)
        if hopper:
            bq = BLOCK_ROWS_D256 if d == 256 else block_rows(b, s, hq)
            err = _entry("flash_attention_bf16_hopper")(*args, bq, stream)
        elif tf32:
            err = _entry("flash_attention_f32_tf32")(*args, stream)
        else:
            err = _entry(_ENTRY[q.dtype])(*args, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    if hopper:
        flash_attention.hopper_launches += 1
    elif tf32:
        flash_attention.tf32_launches += 1
    else:
        flash_attention.cuda_core_launches += 1
    if window:
        flash_attention.window_launches += 1
    if return_lse:
        flash_attention.lse_launches += 1
        return out, lse
    return out


flash_attention.launches = 0
flash_attention.hopper_launches = 0
flash_attention.tf32_launches = 0
flash_attention.cuda_core_launches = 0
flash_attention.lse_launches = 0
flash_attention.window_launches = 0


@torch.library.custom_op(
    "repro_torch::flash_attention_plain", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int window, "
           "float? sm_scale, bool return_lse) -> Tensor[]")
def _plain_torch(q, k, v, causal, window, sm_scale, return_lse):
    """The plain version (``ref.py``) as one operator: [out] or [out,
    lse]."""
    outs = ref.flash_attention(q, k, v, causal=causal, window=window,
                               sm_scale=sm_scale, return_lse=return_lse)
    return list(outs) if return_lse else [outs]


@_plain_torch.register_fake
def _plain_fake_torch(q, k, v, causal, window, sm_scale, return_lse):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if not return_lse:
        return [out]
    b, s, hq, _ = q.shape
    return [out, torch.empty((b, hq, s), dtype=torch.float32,
                             device=q.device)]


def attended_pairs_np(s: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs a head attends over S rows: S^2, the causal
    S (S + 1) / 2, or with a window W the sum over rows i of min(i + 1,
    W)."""
    if not causal:
        return s * s
    w = min(window, s) if window > 0 else s
    return w * (w + 1) // 2 + (s - w) * w


@register_flop_formula(torch.ops.repro_torch.flash_attention_plain)
def _plain_flops_np(q_shape, k_shape, v_shape, causal, window, *args,
                    **kwargs) -> int:
    """The kernel's operations: q.k and p.v, 4 D a (query head, key) pair
    it attends (``attended_pairs_np``)."""
    b, s, hq, d = q_shape
    return 4 * b * hq * d * attended_pairs_np(s, causal, window)


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_int] * (1 if name.endswith("hopper") else 0) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
