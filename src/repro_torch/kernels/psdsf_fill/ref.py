"""Plain PyTorch version of the ``psdsf_fill`` kernel.

``fill_event_levels`` computes what the CUDA kernel computes, phase for
phase, with whole-tensor operations: the slope pass, the bracket pass,
``steps`` bisection passes and the output pass of
``repro/kernels/psdsf_fill/kernel.py::_fill_kernel``. The kernel wrapper
uses it for CPU tensors; the tests hold it against the Pallas kernel in
interpret mode, and ``chip_smoke.py`` holds the CUDA kernel against it on
the card. ``fill_cluster_plain`` is the whole event loop on top of it, an
entry for comparisons only: the solve itself always goes through
``ops.fill_cluster``.
"""
from __future__ import annotations

import torch

BIG = 3.0e38
TOL = 1e-9


def _usage(rate, floors, demands, lvl):
    """(K, R): sum_n d[n, r] rate[n, i] max(0, lvl_i - f[n, i])."""
    return (rate * (lvl[None, :] - floors).clamp(min=0.0)).T @ demands


def fill_event_levels(floors, rate, demands, caps, frozen, saturated, level,
                      *, steps: int):
    """One bisection saturation event for every server.

    floors/rate: (N, K), active-masked (rate 0 and floor 0 for frozen or
    ineligible users); demands: (N, R); caps/frozen: (K, R); saturated:
    (K, R) bool; level: (K,). Returns (level' (K,), usage (K, R),
    local_slope (K, R), total_slope (K, R)) at the event level.
    """
    slope = rate.T @ demands                                   # (K, R)
    zero = torch.zeros((), dtype=floors.dtype, device=floors.device)
    fmax = torch.where(rate > 0, floors, zero).amax(dim=0) \
        if floors.shape[0] else torch.zeros_like(level)
    hi0 = torch.maximum(fmax.clamp(min=0.0), level)
    canb = ~saturated & (slope > TOL)
    head = (caps - frozen - _usage(rate, floors, demands, hi0)).clamp(min=0.0)
    step_up = torch.where(canb, head / slope.clamp(min=TOL),
                          torch.full_like(head, BIG)).amin(dim=1)
    lo = level
    hi = torch.where(canb.any(dim=1), hi0 + step_up, lo)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        u = _usage(rate, floors, demands, mid)
        crossed = (canb & (frozen + u >= caps)).any(dim=1)
        lo, hi = torch.where(crossed, lo, mid), torch.where(crossed, mid, hi)
    lvl = torch.maximum(hi, level)
    u = frozen + _usage(rate, floors, demands, lvl)
    lsl = (rate * (floors <= lvl[None, :])).T @ demands
    return lvl, u, lsl, slope


def fill_cluster_plain(cap, demands, phi, gamma, x_ext, *, mode: str = "rdm"):
    """``ops.fill_cluster`` with every event computed by the plain
    :func:`fill_event_levels` instead of the kernel, on any device."""
    from .ops import _fill_cluster
    return _fill_cluster(fill_event_levels, cap, demands, phi, gamma, x_ext,
                         mode=mode)
