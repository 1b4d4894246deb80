"""``ssd_scan``: the wrapper of the Hopper ``ssd_scan`` kernel.

The kernel (``csrc/ssd_scan.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/ssd_scan/kernel.py::_ssd_kernel``. It is built with
``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA
tensor; CPU tensors take the plain version in ``ref.py``, and nothing else
does. ``ssd_scan.launches`` counts the wrapper's launches: one a call,
whose bfloat16 body runs three CUDA kernels (the chunk scores and deltas,
the state pass, the outputs) on scratch the wrapper allocates
(:func:`scratch_size`), and whose float32 body runs one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

#: chunk lengths the kernel takes (mamba2_1_3b's 128 and its smoke
#: config's 16), and the widest state it holds
CHUNKS = (16, 128)
MAX_STATE = 128
_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def scratch_size(b: int, h: int, s: int, p: int, n: int, chunk: int) -> int:
    """float32 values of the bfloat16 body's scratch: the chunk scores
    C_c B_c^T (B, nc, Q, Q), the chunk deltas (B, nc, H, P, N), the entry
    states as hi and lo bfloat16 planes (the same bytes) and the chunk
    decays (B, H, nc)."""
    nc = -(-s // chunk)
    return b * nc * (chunk * chunk + 2 * h * p * n + h)


def ssd_scan(x, dt, a, b_mat, c_mat, *, chunk: int = 128, init_state=None,
             out=None):
    """x: (B, H, S, P) float32 or bfloat16; dt: (B, H, S) float32, after
    softplus; a: (H,) float32, negative; b_mat, c_mat: (B, S, N) of x's
    dtype; any strides. init_state: (B, H, P, N) float32, contiguous, or
    None (zeros). out: a (B, H, S, P) tensor of x's dtype (any strides) to
    write y into, or None. Returns (y, final state: a contiguous (B, H, P,
    N) float32 tensor)."""
    if x.device.type == "cpu":
        y, state = ref.ssd_scan(x, dt, a, b_mat, c_mat, chunk=chunk,
                                init_state=init_state)
        if out is not None:
            out.copy_(y)
            y = out
        return y, state
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu: {x.device}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, H, S, P): "
                         f"{tuple(x.shape)}")
    b, h, s, p = x.shape
    if x.dtype not in _ENTRY:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x: {x.dtype}")
    if b_mat.dim() != 3 or b_mat.shape[:2] != (b, s):
        raise ValueError(f"ssd_scan: b_mat must be (B, S, N) = ({b}, {s}, "
                         f"N): {tuple(b_mat.shape)}")
    n = b_mat.shape[2]
    if tuple(c_mat.shape) != tuple(b_mat.shape):
        raise ValueError(f"ssd_scan: c_mat {tuple(c_mat.shape)} != b_mat "
                         f"{tuple(b_mat.shape)}")
    if tuple(dt.shape) != (b, h, s) or tuple(a.shape) != (h,):
        raise ValueError(f"ssd_scan: dt must be ({b}, {h}, {s}) and a "
                         f"({h},): {tuple(dt.shape)}, {tuple(a.shape)}")
    for name, t, dtype in (("b_mat", b_mat, x.dtype), ("c_mat", c_mat,
                                                       x.dtype),
                           ("dt", dt, torch.float32),
                           ("a", a, torch.float32)):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"ssd_scan: {name} is {t.dtype} on {t.device},"
                             f" it must be {dtype} on {x.device}")
    if chunk not in CHUNKS:
        raise ValueError(f"ssd_scan takes chunks of {CHUNKS}: {chunk}")
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"ssd_scan takes a state width N of 1.."
                         f"{MAX_STATE}: {n}")
    if init_state is not None and (
            init_state.device != x.device
            or init_state.dtype != torch.float32
            or tuple(init_state.shape) != (b, h, p, n)
            or not init_state.is_contiguous()):
        raise ValueError(f"ssd_scan: init_state must be a contiguous "
                         f"float32 ({b}, {h}, {p}, {n}) tensor on "
                         f"{x.device}")
    if out is None:
        out = torch.empty((b, h, s, p), dtype=x.dtype, device=x.device)
    elif (out.device != x.device or out.dtype != x.dtype
          or tuple(out.shape) != (b, h, s, p)):
        raise ValueError(f"ssd_scan: out must be a {x.dtype} ({b}, {h}, "
                         f"{s}, {p}) tensor on {x.device}")
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b == 0 or h == 0 or p == 0:
        return out, state
    a = a.contiguous()
    strides = (ctypes.c_longlong * 17)(
        *x.stride(), *dt.stride(), *b_mat.stride(), *c_mat.stride(),
        *out.stride())
    ptrs = [x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            out.data_ptr(), state.data_ptr()]
    if x.dtype == torch.bfloat16:
        scratch = torch.empty((scratch_size(b, h, s, p, n, chunk),),
                              dtype=torch.float32, device=x.device)
        ptrs.append(scratch.data_ptr())
    with torch.cuda.device(x.device):
        err = _entry(_ENTRY[x.dtype])(
            *ptrs, strides, b, h, s, p, n, chunk,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return out, state


ssd_scan.launches = 0


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("ssd_scan"), name)
    pointers = 9 if name == _ENTRY[torch.bfloat16] else 8
    fn.argtypes = [ctypes.c_void_p] * pointers \
        + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
