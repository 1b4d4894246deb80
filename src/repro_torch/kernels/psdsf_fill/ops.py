"""Whole-cluster bisection fill on top of the ``psdsf_fill`` kernel.

``fill_cluster`` is the Jacobi round's primitive: rebuild every server's
fill against a fixed external-usage matrix in one shot. Each saturation
event is one call of ``kernel.fill_event_levels`` for all servers at once;
around it runs the freeze-and-repeat event loop of
``repro/kernels/psdsf_fill/ops.py::fill_cluster_padded`` (at most R+1
events, one for TDM) with the same bind rule. Everything stays on the
tensors' device: the loop reads nothing back to the host, and ragged N and
K need no padding because the kernel masks its own edges.
"""
from __future__ import annotations

import torch

from ...core.solveinfo import BISECT_STEPS, BISECT_STEPS_F32
from .kernel import fill_event_levels
from .ref import TOL


def fill_cluster(cap, demands, phi, gamma, x_ext, *, mode: str = "rdm"):
    """Rebuild all K server fills from external usage ``x_ext`` at once.

    cap: (K, R); demands: (N, R); phi: (N,); gamma: (N, K); x_ext: (N, K)
    (user n's tasks on servers other than the column's), all one float
    dtype on one device. Returns the (N, K) fill. ``mode="tdm"`` maps the
    time-share constraint onto one virtual resource of capacity 1. The
    bisection-step count follows the dtype (48 for float64, 26 otherwise).
    CUDA tensors go through the Hopper kernel, CPU tensors through its
    plain version.
    """
    return _fill_cluster(fill_event_levels, cap, demands, phi, gamma, x_ext,
                         mode=mode)


def _fill_cluster(event_levels, cap, demands, phi, gamma, x_ext, *,
                  mode: str):
    n, k = gamma.shape
    dt = gamma.dtype
    eligible = gamma > 0
    zero = torch.zeros((), dtype=dt, device=gamma.device)
    if mode == "tdm":
        rate = torch.where(eligible, phi[:, None], zero)
        dem = torch.ones((n, 1), dtype=dt, device=gamma.device)
        caps = torch.ones((k, 1), dtype=dt, device=gamma.device)
    elif mode == "rdm":
        rate = torch.where(eligible, phi[:, None] * gamma, zero)
        dem = demands.contiguous()
        caps = cap.contiguous()
    else:
        raise ValueError(f"mode must be 'rdm' or 'tdm': {mode!r}")
    # the fill grows x at phi*gamma per unit level whatever the regime;
    # ``rate`` above is the usage slope (for TDM usage is x/gamma = phi*L)
    full_rate = torch.where(eligible, phi[:, None] * gamma, zero)
    floor = torch.where(eligible, x_ext / full_rate.clamp(min=1e-300), zero)
    steps = BISECT_STEPS if dt == torch.float64 else BISECT_STEPS_F32
    eps = torch.finfo(dt).eps
    cap_scale = caps.max().clamp(min=1.0) if caps.numel() else 1.0
    level_tol = max(TOL, 32 * eps)

    x = torch.zeros_like(rate)
    active = rate > 0
    saturated = caps <= TOL * cap_scale
    frozen = torch.zeros_like(caps)
    level = torch.zeros(k, dtype=dt, device=gamma.device)
    for _ in range(1 if mode == "tdm" else caps.shape[1] + 1):
        lvl, u, lsl, slope = event_levels(
            torch.where(active, floor, zero), torch.where(active, rate, zero),
            dem, caps, frozen, saturated, level, steps=steps)
        canb = ~saturated & (slope > TOL)
        bind = canb & (caps - u <= lsl * level_tol + 32 * eps * cap_scale)
        x = torch.where(active,
                        full_rate * (lvl[None, :] - floor).clamp(min=0.0), x)
        newly = active & ((dem @ bind.T.to(dt)) > 0)
        frozen = frozen + torch.where(newly, x, zero).T @ dem
        saturated = saturated | bind
        active = active & ~newly
        level = torch.maximum(level, lvl)
    return x
