"""``vds_argmin``: the wrapper of the Hopper ``psdsf_vds`` kernel.

The kernel (``csrc/psdsf_vds.cu``, CUDA C++ for sm_90a) replaces
``repro/kernels/psdsf_vds/kernel.py::_vds_kernel``. It is built with
``nvcc`` and loaded through ``ctypes`` on the first call with a CUDA tensor;
CPU tensors take the plain version in ``ref.py``, and nothing else does.
``vds_argmin.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref


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
    with torch.cuda.device(gamma.device):
        err = _entry()(x_over_phi.data_ptr(), gamma.data_ptr(),
                       mn.data_ptr(), arg.data_ptr(), n, k,
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"psdsf_vds kernel launch failed: CUDA error {err}")
    vds_argmin.launches += 1
    return mn, arg


vds_argmin.launches = 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("psdsf_vds").psdsf_vds_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
