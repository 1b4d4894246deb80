"""``ssd_scan``: the wrapper of the Hopper ``ssd_scan`` kernel.

The kernel (``csrc/ssd_scan.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/ssd_scan/kernel.py::_ssd_kernel``. It is built with
``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA
tensor; CPU tensors take the plain version in ``ref.py``, and nothing else
does. ``ssd_scan.launches`` counts the wrapper's launches: one a call,
which runs three CUDA kernels (the chunk scores and deltas, the state pass,
the outputs) on scratch the wrapper allocates (:func:`scratch_size`), in
bfloat16 and float32 alike (float32 x, B and C split into two bfloat16
terms each on the tensor cores).

On CPU tensors the plain version runs as one operator,
``torch.ops.repro_torch.ssd_scan_plain`` (``_plain_torch``), with a fake
implementation and a FLOP formula: a trace under a ``FakeTensorMode``
(``launch/dryrun.py``) sees the kernel's inputs, outputs and operations,
not the plain version's float32 intermediates.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from torch.utils.flop_counter import register_flop_formula

from .. import _build
from . import ref

#: chunk lengths the kernel takes (mamba2_1_3b's 128, jamba_v0_1_52b's 64
#: and both smoke configs' 16), and the widest state it holds
CHUNKS = (16, 64, 128)
MAX_STATE = 128
_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def scratch_size(b: int, h: int, s: int, p: int, n: int, chunk: int) -> int:
    """float32 values of the kernel's scratch: the chunk scores
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
        if out is None:
            out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        return out, _plain_torch(x, dt, a, b_mat, c_mat, chunk, init_state,
                                 out)
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


@torch.library.custom_op(
    "repro_torch::ssd_scan_plain", mutates_args=("out",),
    schema="(Tensor x, Tensor dt, Tensor a, Tensor b_mat, Tensor c_mat, "
           "int chunk, Tensor? init_state, Tensor(a!) out) -> Tensor")
def _plain_torch(x, dt, a, b_mat, c_mat, chunk, init_state, out):
    """The plain version (``ref.py``) as one operator: writes y into
    ``out`` and returns the final state."""
    y, state = ref.ssd_scan(x, dt, a, b_mat, c_mat, chunk=chunk,
                            init_state=init_state)
    out.copy_(y)
    return state


@_plain_torch.register_fake
def _plain_fake_torch(x, dt, a, b_mat, c_mat, chunk, init_state, out):
    b, h, _, p = x.shape
    return torch.empty((b, h, p, b_mat.shape[2]), dtype=torch.float32,
                       device=x.device)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_plain)
def _plain_flops_np(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk,
                    *args, **kwargs) -> int:
    """The kernel's operations, chunk by chunk (the ragged last one at its
    own length c): the causal C B^T, shared by the heads, c (c + 1) N; per
    head the causal W x, c (c + 1) P, and C state^T and x^T B, 4 c N P."""
    b, h, s, p = x_shape
    n = b_shape[2]
    lengths = [chunk] * (s // chunk) + ([s % chunk] if s % chunk else [])
    return b * sum(c * (c + 1) * n + h * (c * (c + 1) * p + 4 * c * n * p)
                   for c in lengths)


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("ssd_scan"), name)
    fn.argtypes = [ctypes.c_void_p] * 9 \
        + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
