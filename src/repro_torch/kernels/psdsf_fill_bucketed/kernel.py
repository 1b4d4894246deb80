"""``fill_event_levels_bucketed``: the wrapper of the Hopper
``psdsf_fill_bucketed`` kernel.

The kernel (``csrc/psdsf_fill_bucketed.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/psdsf_fill_bucketed/kernel.py::_fill_bucketed_kernel``. It is
built with ``nvcc`` and loaded through ``ctypes`` on the first call with a
CUDA tensor; CPU tensors take the plain version in ``ref.py``, and nothing
else does. ``fill_event_levels_bucketed.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

#: resource counts the CUDA source instantiates (its ``R`` template cases)
MAX_RESOURCES = 8

#: threads a block, one block a server (the CUDA source's ``NT``): a
#: float64 thread holds about the bytes of slots a float32 thread does
THREADS = {torch.float64: 128, torch.float32: 64}

#: slots a thread the register path instantiates (its ``S`` cases): a
#: bucket is held in registers for the whole event when it fits in
#: THREADS * S slots for one of them whose S * (R + 2) values take at most
#: REG_WORDS_MAX 32-bit registers a thread (the CUDA source's own bound)
REG_SLOTS = (1, 2, 4, 6, 8, 12, 16)
REG_WORDS_MAX = 96

#: a bucket off the register path (Bmax * (R + 2) values) is staged in
#: shared memory when it fits in this many bytes (the H100's 227 KB per
#: block, less the kernel's static partials; the CUDA source's
#: SMEM_DYN_MAX), and read from device memory in every pass otherwise
SMEM_STAGE_MAX = 220 * 1024


def plan(bmax: int, r: int, dtype, steps: int) -> dict:
    """How the kernel runs one event on buckets of ``bmax`` slots: threads a
    block, slots a thread in registers (0 off the register path), the path
    (``registers``, ``shared`` or ``streamed``) and the passes an event
    takes (the slope, bracket and output passes and one a bisection step).
    The dict is cached and shared: read it, do not change it."""
    return _plan(bmax, r, dtype, steps, REG_SLOTS, SMEM_STAGE_MAX)


@functools.lru_cache(maxsize=None)
def _plan(bmax, r, dtype, steps, reg_slots, smem_stage_max) -> dict:
    threads = THREADS[dtype]
    words = dtype.itemsize // 4
    need = -(-bmax // threads)
    fits = [s for s in reg_slots
            if need <= s and s * (r + 2) * words <= REG_WORDS_MAX]
    if fits:
        slots, path = fits[0], "registers"
    else:
        slots = 0
        path = "shared" if bmax * (r + 2) * words * 4 <= smem_stage_max \
            else "streamed"
    return dict(threads=threads, slots=slots, path=path, passes=3 + steps)


def fill_event_levels_bucketed(floors, rate, dem_b, caps, frozen, saturated,
                               level, *, steps: int):
    """One bisection saturation event for every server, bucket layout.

    floors/rate: (K, Bmax), active-masked; dem_b: (K, Bmax, R); caps/frozen:
    (K, R); saturated: (K, R) bool; level: (K,); all floats of one dtype
    (float32 or float64), contiguous, on one device. Returns (level' (K,),
    usage (K, R), local_slope (K, R), total_slope (K, R)).
    """
    if floors.device.type == "cpu":
        return ref.fill_event_levels_bucketed(
            floors, rate, dem_b, caps, frozen, saturated, level, steps=steps)
    if floors.device.type != "cuda":
        raise ValueError(f"psdsf_fill_bucketed runs on cuda or cpu: "
                         f"{floors.device}")
    k, bmax = floors.shape
    r = dem_b.shape[2] if dem_b.dim() == 3 else -1
    dt = floors.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"psdsf_fill_bucketed takes float32 or float64: {dt}")
    want = {"floors": (floors, (k, bmax), dt), "rate": (rate, (k, bmax), dt),
            "dem_b": (dem_b, (k, bmax, r), dt), "caps": (caps, (k, r), dt),
            "frozen": (frozen, (k, r), dt),
            "saturated": (saturated, (k, r), torch.bool),
            "level": (level, (k,), dt)}
    for name, (t, shape, dtype) in want.items():
        if t.device != floors.device or tuple(t.shape) != shape \
                or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"psdsf_fill_bucketed: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {floors.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 1 <= r <= MAX_RESOURCES:
        raise ValueError(f"psdsf_fill_bucketed takes 1..{MAX_RESOURCES} "
                         f"resources: {r}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0: {steps}")
    lvl = torch.empty((k,), dtype=dt, device=floors.device)
    u = torch.empty((k, r), dtype=dt, device=floors.device)
    lsl = torch.empty((k, r), dtype=dt, device=floors.device)
    slope = torch.empty((k, r), dtype=dt, device=floors.device)
    if k == 0:
        return lvl, u, lsl, slope
    how = plan(bmax, r, dt, steps)
    fn = _entry("psdsf_fill_bucketed_f64" if dt == torch.float64
                else "psdsf_fill_bucketed_f32")
    with torch.cuda.device(floors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(floors.data_ptr(), rate.data_ptr(), dem_b.data_ptr(),
                 caps.data_ptr(), frozen.data_ptr(), saturated.data_ptr(),
                 level.data_ptr(), lvl.data_ptr(), u.data_ptr(),
                 lsl.data_ptr(), slope.data_ptr(), k, bmax, r, steps,
                 how["slots"], int(how["path"] == "shared"), stream)
    if err:
        raise RuntimeError(f"psdsf_fill_bucketed kernel launch failed: CUDA "
                           f"error {err}")
    fill_event_levels_bucketed.launches += 1
    return lvl, u, lsl, slope


fill_event_levels_bucketed.launches = 0


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    fn = getattr(_build.load("psdsf_fill_bucketed"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
