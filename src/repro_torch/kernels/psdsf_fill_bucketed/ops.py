"""Bucketed whole-cluster bisection fill on top of the
``psdsf_fill_bucketed`` kernel.

``fill_cluster_bucketed`` is the bucket layout's Jacobi-round primitive,
the port of ``repro/kernels/psdsf_fill_bucketed/ops.py::
fill_cluster_bucketed_padded``: rebuild every server's fill against fixed
external usage, each server seeing only its bucket's rows. Each saturation
event is one call of ``kernel.fill_event_levels_bucketed`` for all servers
at once; around it runs the same freeze-and-repeat event loop (R+1 events,
one for TDM) with the same bind rule and the same global ``cap_scale``.
Everything stays on the tensors' device with no read-back, and ragged K and
Bmax need no padding because the kernel masks its own edges.
"""
from __future__ import annotations

import torch

from ...core.solveinfo import BISECT_STEPS, BISECT_STEPS_F32
from .kernel import fill_event_levels_bucketed
from .ref import TOL


def fill_cluster_bucketed(cap, dem_b, phi_b, gam_b, x_ext_b, mask, *,
                          mode: str = "rdm"):
    """Rebuild all K server fills from bucketed external usage at once.

    cap: (K, R); dem_b: (K, Bmax, R) gathered demand rows; phi_b / gam_b /
    x_ext_b: (K, Bmax) gathered weights / per-server gammas / external task
    counts; mask: (K, Bmax) bool validity of each slot; all floats of one
    dtype on one device. Returns the (K, Bmax) fill (masked slots 0).
    ``mode="tdm"`` maps the time-share constraint onto one virtual resource
    of capacity 1. The bisection-step count follows the dtype (48 for
    float64, 26 otherwise). CUDA tensors go through the Hopper kernel, CPU
    tensors through its plain version.
    """
    return _fill_cluster_bucketed(fill_event_levels_bucketed, cap, dem_b,
                                  phi_b, gam_b, x_ext_b, mask, mode=mode)


def _fill_cluster_bucketed(event_levels, cap, dem_b, phi_b, gam_b, x_ext_b,
                           mask, *, mode: str):
    k, bmax = gam_b.shape
    dt, dev = gam_b.dtype, gam_b.device
    live = mask & (gam_b > 0)
    zero = torch.zeros((), dtype=dt, device=dev)
    if mode == "tdm":
        rate = torch.where(live, phi_b, zero)
        dem = torch.ones((k, bmax, 1), dtype=dt, device=dev)
        caps = torch.ones((k, 1), dtype=dt, device=dev)
    elif mode == "rdm":
        rate = torch.where(live, phi_b * gam_b, zero)
        dem = dem_b.contiguous()
        caps = cap.contiguous()
    else:
        raise ValueError(f"mode must be 'rdm' or 'tdm': {mode!r}")
    # the fill grows x at phi*gamma per unit level whatever the regime;
    # ``rate`` above is the usage slope (for TDM usage is x/gamma = phi*L)
    full_rate = torch.where(live, phi_b * gam_b, zero)
    floor = torch.where(live, x_ext_b / full_rate.clamp(min=1e-300), zero)
    steps = BISECT_STEPS if dt == torch.float64 else BISECT_STEPS_F32
    eps = torch.finfo(dt).eps
    cap_scale = caps.max().clamp(min=1.0) if caps.numel() else 1.0
    level_tol = max(TOL, 32 * eps)

    x = torch.zeros_like(rate)
    active = rate > 0
    saturated = caps <= TOL * cap_scale
    frozen = torch.zeros_like(caps)
    level = torch.zeros(k, dtype=dt, device=dev)
    for _ in range(1 if mode == "tdm" else caps.shape[1] + 1):
        lvl, u, lsl, slope = event_levels(
            torch.where(active, floor, zero), torch.where(active, rate, zero),
            dem, caps, frozen, saturated, level, steps=steps)
        canb = ~saturated & (slope > TOL)
        bind = canb & (caps - u <= lsl * level_tol + 32 * eps * cap_scale)
        x = torch.where(active,
                        full_rate * (lvl[:, None] - floor).clamp(min=0.0), x)
        # slot (i, b) freezes when its user demands a newly bound resource
        newly = active & (torch.einsum("kbr,kr->kb", dem, bind.to(dt)) > 0)
        frozen = frozen + torch.einsum("kb,kbr->kr",
                                       torch.where(newly, x, zero), dem)
        saturated = saturated | bind
        active = active & ~newly
        level = torch.maximum(level, lvl)
    return x
