"""``vds_argmin``: the wrapper of the Hopper ``psdsf_vds`` kernel.

The kernel (``csrc/psdsf_vds.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/psdsf_vds/kernel.py::_vds_kernel``. It is built with
``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA tensor;
CPU tensors take the plain version in ``ref.py``, and nothing else does.
A call launches the slab kernel and, when the grid has more than one user
slab, the merge kernel after it; ``vds_argmin.launches`` counts the calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

#: server columns a block takes (the CUDA source's CT: 32 lanes x 4)
COLUMNS_PER_BLOCK = 128
#: fewest user rows a slab takes
MIN_SLAB_ROWS = 64


def grid(n: int, k: int, sms: int) -> dict:
    """The kernel's grid for (N, K) on a card of ``sms`` SMs: column
    tiles, user slabs and the rows a slab takes (the last one ragged).
    With one slab no merge kernel runs. It aims at four slab blocks an SM
    (two and eight read slower at 20,000 x 256 and 20,000 x 1,024)."""
    blocks_per_sm = 4
    tiles = -(-k // COLUMNS_PER_BLOCK)
    want = max(1, -(-blocks_per_sm * sms // tiles))
    slabs = max(1, min(want, -(-n // MIN_SLAB_ROWS)))
    rows = -(-n // slabs)
    return dict(tiles=tiles, slabs=-(-n // rows), rows=rows)


def vds_argmin(x_over_phi, gamma):
    """x_over_phi: (N,) float32; gamma: (N, K) float32, contiguous, one
    device, N >= 1. Returns (min (K,) float32, argmin user (K,) int32)."""
    if gamma.device.type == "cpu":
        return ref.vds_argmin(x_over_phi, gamma)
    if gamma.device.type != "cuda":
        raise ValueError(f"psdsf_vds runs on cuda or cpu: {gamma.device}")
    n, k = gamma.shape
    for name, t, shape in (("x_over_phi", x_over_phi, (n,)),
                           ("gamma", gamma, (n, k))):
        if t.device != gamma.device or tuple(t.shape) != shape \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"psdsf_vds: {name} must be a contiguous float32 tensor of "
                f"shape {shape} on {gamma.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if n == 0:
        raise ValueError("psdsf_vds needs at least one user row")
    mn = torch.empty((k,), dtype=torch.float32, device=gamma.device)
    arg = torch.empty((k,), dtype=torch.int32, device=gamma.device)
    if k == 0:
        return mn, arg
    plan = grid(n, k, _sm_count(gamma.device))
    # the slabs' partials; a single slab writes the outputs directly
    shape = (plan["slabs"], k) if plan["slabs"] > 1 else (0,)
    part_min = torch.empty(shape, dtype=torch.float32, device=gamma.device)
    part_arg = torch.empty(shape, dtype=torch.int32, device=gamma.device)
    with torch.cuda.device(gamma.device):
        err = _entry("psdsf_vds_f32")(
            x_over_phi.data_ptr(), gamma.data_ptr(), part_min.data_ptr(),
            part_arg.data_ptr(), mn.data_ptr(), arg.data_ptr(), n, k,
            plan["rows"], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"psdsf_vds kernel launch failed: CUDA error {err}")
    vds_argmin.launches += 1
    return mn, arg


vds_argmin.launches = 0


def merge_slabs(part_min, part_arg):
    """The merge kernel alone on (slabs, K) partials, as ``vds_argmin``
    runs it after the slab kernel: (min (K,), argmin (K,)). For timing the
    merge; not counted in ``vds_argmin.launches``."""
    if part_min.dim() != 2 or part_min.device.type != "cuda" \
            or part_min.dtype != torch.float32 \
            or part_arg.dtype != torch.int32 \
            or part_arg.shape != part_min.shape \
            or part_arg.device != part_min.device \
            or not (part_min.is_contiguous() and part_arg.is_contiguous()):
        raise ValueError("merge_slabs takes contiguous (slabs, K) float32 "
                         "minima and int32 rows on one CUDA device")
    slabs, k = part_min.shape
    if slabs == 0 or k == 0:
        raise ValueError(f"merge_slabs needs slabs and columns: {slabs}x{k}")
    mn = torch.empty((k,), dtype=torch.float32, device=part_min.device)
    arg = torch.empty((k,), dtype=torch.int32, device=part_min.device)
    with torch.cuda.device(part_min.device):
        err = _entry("psdsf_vds_merge_f32")(
            part_min.data_ptr(), part_arg.data_ptr(), mn.data_ptr(),
            arg.data_ptr(), slabs, k,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"psdsf_vds merge launch failed: CUDA error {err}")
    return mn, arg


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


#: each entry's (pointers, ints) before its stream
_ARGS = {"psdsf_vds_f32": (6, 3), "psdsf_vds_merge_f32": (4, 2)}


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    fn = getattr(_build.load("psdsf_vds"), symbol)
    ptrs, ints = _ARGS[symbol]
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
