"""``fill_event_levels``: the wrapper of the Hopper ``psdsf_fill`` kernel.

The kernel (``csrc/psdsf_fill.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/psdsf_fill/kernel.py::_fill_kernel``. It is built with
``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA tensor;
CPU tensors take the plain version in ``ref.py``, and nothing else does.
``fill_event_levels.launches`` counts the kernel's launches.

Each tile of ``tile_servers`` servers goes to one thread-block cluster,
whose blocks split the users into slices and keep each slice's rows with a
nonzero rate in shared memory for all passes; :func:`plan` chooses the
cluster size and those rows' room from the shapes alone (no host sync).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

#: resource counts the CUDA source instantiates (its ``R`` template cases)
MAX_RESOURCES = 8
#: an H100's SMs
SMS = 132
#: the most dynamic shared memory a block takes for a whole slice (the
#: kernel's own shared arrays take under 16 KB of a block's 227), and the
#: room for kept rows when the slice is larger (three blocks per SM)
SMEM_MAX = 211 * 1024
SMEM_KEPT = 56 * 1024


def tile_servers(itemsize: int) -> int:
    """Servers per tile: one 32-byte sector of a row."""
    return 32 // itemsize


def plan(n: int, k: int, r: int, itemsize: int):
    """(cluster, rows cap) of one launch, from the shapes alone. The
    cluster (1, 2, 4 or 8 blocks per server tile) is the smallest that
    keeps the grid at one block per SM or more: a pass's cost grows with
    the blocks that exchange partials. Each block's slice is ceil(N /
    cluster) users, and it may keep ``cap`` rows (TK floors, TK rates, R
    demands) in shared memory: the whole slice when it fits in
    ``SMEM_MAX``, else what fits in ``SMEM_KEPT``, which on the main
    paths' data (3% eligibility) holds every row with a nonzero rate."""
    tk = tile_servers(itemsize)
    tiles = -(-k // tk)
    cluster = 8
    while cluster > 1 and tiles * (cluster // 2) >= SMS:
        cluster //= 2
    slice_rows = -(-n // cluster)
    row_bytes = (2 * tk + r) * itemsize
    budget = SMEM_MAX if slice_rows * row_bytes <= SMEM_MAX else SMEM_KEPT
    return cluster, min(slice_rows, budget // row_bytes)


def fill_event_levels(floors, rate, demands, caps, frozen, saturated, level,
                      *, steps: int):
    """One bisection saturation event for every server.

    floors/rate: (N, K), active-masked; demands: (N, R); caps/frozen:
    (K, R); saturated: (K, R) bool; level: (K,); all floats of one dtype
    (float32 or float64), contiguous, on one device. Returns (level' (K,),
    usage (K, R), local_slope (K, R), total_slope (K, R)).
    """
    if floors.device.type == "cpu":
        return ref.fill_event_levels(floors, rate, demands, caps, frozen,
                                     saturated, level, steps=steps)
    if floors.device.type != "cuda":
        raise ValueError(f"psdsf_fill runs on cuda or cpu: {floors.device}")
    n, k = floors.shape
    r = demands.shape[1]
    dt = floors.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"psdsf_fill takes float32 or float64: {dt}")
    want = {"floors": (floors, (n, k), dt), "rate": (rate, (n, k), dt),
            "demands": (demands, (n, r), dt), "caps": (caps, (k, r), dt),
            "frozen": (frozen, (k, r), dt),
            "saturated": (saturated, (k, r), torch.bool),
            "level": (level, (k,), dt)}
    for name, (t, shape, dtype) in want.items():
        if t.device != floors.device or tuple(t.shape) != shape \
                or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"psdsf_fill: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {floors.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 1 <= r <= MAX_RESOURCES:
        raise ValueError(f"psdsf_fill takes 1..{MAX_RESOURCES} resources: {r}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0: {steps}")
    lvl = torch.empty((k,), dtype=dt, device=floors.device)
    u = torch.empty((k, r), dtype=dt, device=floors.device)
    lsl = torch.empty((k, r), dtype=dt, device=floors.device)
    slope = torch.empty((k, r), dtype=dt, device=floors.device)
    if k == 0:
        return lvl, u, lsl, slope
    fn = _entry("psdsf_fill_f64" if dt == torch.float64 else "psdsf_fill_f32")
    cluster, cap = plan(n, k, r, floors.element_size())
    with torch.cuda.device(floors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(floors.data_ptr(), rate.data_ptr(), demands.data_ptr(),
                 caps.data_ptr(), frozen.data_ptr(), saturated.data_ptr(),
                 level.data_ptr(), lvl.data_ptr(), u.data_ptr(),
                 lsl.data_ptr(), slope.data_ptr(), n, k, r, steps, cluster,
                 cap, stream)
    if err:
        raise RuntimeError(f"psdsf_fill kernel launch failed: CUDA error "
                           f"{err}")
    fill_event_levels.launches += 1
    return lvl, u, lsl, slope


fill_event_levels.launches = 0


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    fn = getattr(_build.load("psdsf_fill"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
