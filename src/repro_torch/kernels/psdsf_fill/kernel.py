"""``fill_event_levels``: the wrapper of the Hopper ``psdsf_fill`` kernel.

The kernel (``csrc/psdsf_fill.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/psdsf_fill/kernel.py::_fill_kernel``. It is built with
``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA tensor;
CPU tensors take the plain version in ``ref.py``, and nothing else does.
``fill_event_levels.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

#: resource counts the CUDA source instantiates (its ``R`` template cases)
MAX_RESOURCES = 8


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
    with torch.cuda.device(floors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(floors.data_ptr(), rate.data_ptr(), demands.data_ptr(),
                 caps.data_ptr(), frozen.data_ptr(), saturated.data_ptr(),
                 level.data_ptr(), lvl.data_ptr(), u.data_ptr(),
                 lsl.data_ptr(), slope.data_ptr(), n, k, r, steps, stream)
    if err:
        raise RuntimeError(f"psdsf_fill kernel launch failed: CUDA error "
                           f"{err}")
    fill_event_levels.launches += 1
    return lvl, u, lsl, slope


fill_event_levels.launches = 0


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    fn = getattr(_build.load("psdsf_fill"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
