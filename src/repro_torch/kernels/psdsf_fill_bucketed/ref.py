"""Plain PyTorch version of the ``psdsf_fill_bucketed`` kernel.

``fill_event_levels_bucketed`` computes what the CUDA kernel computes,
phase for phase, with whole-tensor operations: the slope pass, the bracket
pass, ``steps`` bisection passes and the output pass of
``repro/kernels/psdsf_fill_bucketed/kernel.py::_fill_bucketed_kernel``,
each a per-server contraction over the bucket axis. The kernel wrapper uses
it for CPU tensors; the tests hold it against the Pallas kernel in
interpret mode, and ``chip_smoke.py`` holds the CUDA kernel against it on
the card. ``fill_cluster_bucketed_plain`` is the whole event loop on top of
it, an entry for comparisons only: the solve itself always goes through
``ops.fill_cluster_bucketed``.
"""
from __future__ import annotations

import torch

BIG = 3.0e38
TOL = 1e-9


def _contract(w, dem_b):
    """(K, Bmax) weights x (K, Bmax, R) demands -> (K, R) per-server
    sums over the bucket axis."""
    return torch.einsum("kb,kbr->kr", w, dem_b)


def _usage(rate, floors, dem_b, lvl):
    """(K, R): sum_b d[i, b, r] rate[i, b] max(0, lvl_i - f[i, b])."""
    return _contract(rate * (lvl[:, None] - floors).clamp(min=0.0), dem_b)


def fill_event_levels_bucketed(floors, rate, dem_b, caps, frozen, saturated,
                               level, *, steps: int):
    """One bisection saturation event for every server, bucket layout.

    floors/rate: (K, Bmax), active-masked (rate 0 and floor 0 for frozen,
    ineligible or padded slots); dem_b: (K, Bmax, R) gathered demand rows;
    caps/frozen: (K, R); saturated: (K, R) bool; level: (K,). Returns
    (level' (K,), usage (K, R), local_slope (K, R), total_slope (K, R)) at
    the event level.
    """
    slope = _contract(rate, dem_b)                             # (K, R)
    zero = torch.zeros((), dtype=floors.dtype, device=floors.device)
    fmax = torch.where(rate > 0, floors, zero).amax(dim=1) \
        if floors.shape[1] else torch.zeros_like(level)
    hi0 = torch.maximum(fmax.clamp(min=0.0), level)
    canb = ~saturated & (slope > TOL)
    head = (caps - frozen - _usage(rate, floors, dem_b, hi0)).clamp(min=0.0)
    step_up = torch.where(canb, head / slope.clamp(min=TOL),
                          torch.full_like(head, BIG)).amin(dim=1)
    lo = level
    # no resource of the server can bind: the bracket collapses to lo
    hi = torch.where(canb.any(dim=1), hi0 + step_up, lo)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        u = _usage(rate, floors, dem_b, mid)
        crossed = (canb & (frozen + u >= caps)).any(dim=1)
        lo, hi = torch.where(crossed, lo, mid), torch.where(crossed, mid, hi)
    lvl = torch.maximum(hi, level)
    u = frozen + _usage(rate, floors, dem_b, lvl)
    lsl = _contract(rate * (floors <= lvl[:, None]), dem_b)
    return lvl, u, lsl, slope


def fill_cluster_bucketed_plain(cap, dem_b, phi_b, gam_b, x_ext_b, mask, *,
                                mode: str = "rdm"):
    """``ops.fill_cluster_bucketed`` with every event computed by the plain
    :func:`fill_event_levels_bucketed` instead of the kernel, on any
    device."""
    from .ops import _fill_cluster_bucketed
    return _fill_cluster_bucketed(fill_event_levels_bucketed, cap, dem_b,
                                  phi_b, gam_b, x_ext_b, mask, mode=mode)
