"""PS-DSF solve on tensors (RDM and TDM): the port of
``repro/core/psdsf_jax.py`` for the dense layout.

Same math as the reference: every round rebuilds each server's fill by
water-filling its users up to the first saturated resource, damped, until
the residual passes ``tol * scale`` or ``max_rounds`` is spent.

* ``round="gauss"`` refills the servers one after another (Gauss-Seidel),
  each against the current usage, with one of the four per-server fills
  (``fill="event"``: sorted saturation-event scan; ``fill="bisect"``: the
  sort-free bisection with an exact segment root). These stay plain torch,
  as the reference leaves them to jnp outside any Pallas kernel.
* ``round="jacobi"`` refills every server at once against the previous
  round's usage. With ``fill="bisect"`` that whole-cluster fill is
  ``kernels/psdsf_fill/ops.fill_cluster``: the Hopper kernel for CUDA
  tensors, its plain version for CPU tensors. With ``fill="event"`` it is
  the event fill batched over the server axis.

The per-server fills are written for a batch of S servers at once (columns
of (N, S) tensors): Gauss-Seidel calls them with S = 1. The reference's
data-dependent ``while_loop`` exits become fixed-bound loops whose state
stops changing once a server's exit condition holds, and which end early
once it holds for every server; the results are the reference's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..kernels.psdsf_fill.ops import fill_cluster
from .gamma import gamma_matrix
from .solveinfo import BISECT_STEPS, BISECT_STEPS_F32, FILL_ENGINES
from .types import Allocation, AllocationProblem

_BIG = 1e30
_TOL = 1e-9

#: values of the reference's axes that this slice does not port yet, with
#: the ROADMAP.md item that will
_NOT_PORTED = {
    ("placement", "headroom"): "ROADMAP.md queue 1 item 6 (placement cores)",
    ("layout", "bucketed"): "ROADMAP.md queue 1 item 4 (sparse path)",
    ("layout", "auto"): "ROADMAP.md queue 1 item 4 (sparse path; 'auto' "
                        "resolves to it on sparse instances)",
    ("accel", "anderson"): "ROADMAP.md queue 1 item 5 (convergence layer)",
}
PLACEMENTS = ("level", "headroom", "bestfit", "lexmm")
LAYOUTS = ("dense", "bucketed", "auto")
ACCEL_ENGINES = ("none", "anderson")
ROUNDS = ("gauss", "jacobi")
MODES = ("rdm", "tdm")


def check_axes(*, mode: str = "rdm", placement: str = "level",
               fill: str = "event", round: str = "gauss",
               layout: str = "dense", accel: str = "none") -> None:
    """Validate the engine axes: ``ValueError`` for every value the
    reference rejects on its jitted path, ``NotImplementedError`` naming the
    ROADMAP item for a value the reference takes but the port does not yet
    run."""
    for axis, value, allowed in (("mode", mode, MODES),
                                 ("placement", placement, PLACEMENTS),
                                 ("fill", fill, FILL_ENGINES),
                                 ("round", round, ROUNDS),
                                 ("layout", layout, LAYOUTS),
                                 ("accel", accel, ACCEL_ENGINES)):
        if value not in allowed:
            raise ValueError(f"{axis} must be one of {allowed}: {value!r}")
    if placement == "bestfit":
        raise ValueError("placement 'bestfit' has no device mirror (the "
                         "reference runs it on its numpy engine only)")
    for axis, value in (("placement", placement), ("layout", layout),
                        ("accel", accel)):
        where = _NOT_PORTED.get((axis, value))
        if where:
            raise NotImplementedError(
                f"{axis}={value!r} is not ported to repro_torch yet: {where}")


def _bisect_steps(dtype) -> int:
    return BISECT_STEPS if dtype == torch.float64 else BISECT_STEPS_F32


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _big(t):
    return torch.full((), _BIG, dtype=t.dtype, device=t.device)


def _contract(w, demands):
    """(N, S) weights x (N, R) demands -> (S, R) per-server usage sums."""
    return w.T @ demands


# ---------------------------------------------------------------------------
# the four per-server fills, each over a batch of S servers (columns)
# ---------------------------------------------------------------------------

def _fill_one_server_rdm(cap, demands, phi, gamma, x_ext):
    """Event fill (port of ``psdsf_jax._fill_one_server_rdm``): users are
    sorted by floor once, and each of the R+1 saturation events scans the
    breakpoints for the first crossing level. cap (S, R); demands (N, R);
    phi (N,); gamma, x_ext (N, S). Returns the (N, S) fill."""
    n, r_cnt = demands.shape
    eligible = gamma > 0
    zero, big = _zero(gamma), _big(gamma)
    rate = torch.where(eligible, phi[:, None] * gamma, zero)
    floor = torch.where(eligible, x_ext / rate.clamp(min=1e-300), big)
    order = torch.argsort(floor, dim=0, stable=True)               # (N, S)
    f_s = torch.gather(floor, 0, order)
    rt_s = torch.gather(rate, 0, order)
    dm_s = demands[order]                                          # (N, S, R)
    nxt = torch.cat([f_s[1:], torch.full_like(f_s[:1], _BIG)])[..., None]
    f3 = f_s[..., None]

    cap_scale = cap.amax(dim=1).clamp(min=1.0)                     # (S,)
    x_s = torch.zeros_like(f_s)
    active = torch.gather(eligible, 0, order)
    saturated = cap <= _TOL * cap_scale[:, None]
    frozen = torch.zeros_like(cap)
    level = torch.zeros_like(cap_scale)
    for _ in range(r_cnt + 1):
        any_active = active.any(dim=0)
        rate_a = torch.where(active, rt_s, zero)
        slope = dm_s * rate_a[..., None]
        cum_slope = torch.cumsum(slope, dim=0)
        cum_sf = torch.cumsum(slope * f3, dim=0)
        usage_bp = cum_slope * f3 - cum_sf + frozen[None]
        cand = f3 + (cap[None] - usage_bp) / cum_slope.clamp(min=1e-300)
        valid = (cum_slope > _TOL) & (cand <= nxt + _TOL)
        cand = torch.where(valid, torch.maximum(cand, f3), big)
        lr = torch.where(saturated, big, cand.amin(dim=0))         # (S, R)
        best = torch.maximum(lr.amin(dim=1), level)                # (S,)
        bind = (lr <= best[:, None] * (1 + 1e-12) + _TOL) & ~saturated
        new_x = torch.where(active, rate_a * (best[None] - f_s).clamp(min=0.0),
                            x_s)
        newly = active & ((dm_s * bind[None]).sum(dim=2) > 0)
        new_frozen = frozen + torch.einsum(
            "ns,nsr->sr", torch.where(newly, new_x, zero), dm_s)
        ok = any_active & (best < _BIG * 0.5)                      # (S,)
        x_s = torch.where(ok[None], new_x, x_s)
        frozen = torch.where(ok[:, None], new_frozen, frozen)
        saturated = torch.where(ok[:, None], saturated | bind, saturated)
        active = torch.where(ok[None], active & ~newly, active)
        level = torch.where(ok, best, level)
    return torch.zeros_like(x_s).scatter(0, order, x_s)


def _fill_one_server_tdm(demands, phi, gamma, x_ext):
    """Event fill under TDM (port of ``psdsf_jax._fill_one_server_tdm``):
    one virtual resource sum x/gamma <= 1, one closed-form scan."""
    del demands
    eligible = gamma > 0
    zero, big = _zero(gamma), _big(gamma)
    rate = torch.where(eligible, phi[:, None], zero)           # d(x/gamma)/dL
    floor = torch.where(eligible,
                        x_ext / (phi[:, None] * gamma).clamp(min=1e-300), big)
    order = torch.argsort(floor, dim=0, stable=True)
    f_s = torch.gather(floor, 0, order)
    rt_s = torch.gather(rate, 0, order)
    cum_rt = torch.cumsum(rt_s, dim=0)
    cum_rf = torch.cumsum(rt_s * f_s, dim=0)
    usage_bp = cum_rt * f_s - cum_rf
    cand = f_s + (1.0 - usage_bp) / cum_rt.clamp(min=1e-300)
    nxt = torch.cat([f_s[1:], torch.full_like(f_s[:1], _BIG)])
    valid = (cum_rt > _TOL) & (cand <= nxt + _TOL)
    level = torch.where(valid, torch.maximum(cand, f_s), big).amin(dim=0)
    has = eligible.any(dim=0)
    return torch.where(eligible & has[None],
                       phi[:, None] * gamma
                       * (level[None] - floor).clamp(min=0.0), zero)


def _fill_one_server_rdm_bisect(cap, demands, phi, gamma, x_ext):
    """Sort-free fill (port of ``psdsf_jax._fill_one_server_rdm_bisect``):
    per saturation event, bisect the bracket [level, max active floor +
    tightest headroom step] until no active floor lies inside, then take
    the exact linear-segment root. cap (S, R); demands (N, R); phi (N,);
    gamma, x_ext (N, S). Returns the (N, S) fill."""
    n, r_cnt = demands.shape
    dt = demands.dtype
    steps = _bisect_steps(dt)
    eligible = gamma > 0
    zero, big = _zero(gamma), _big(gamma)
    rate = torch.where(eligible, phi[:, None] * gamma, zero)
    floor = torch.where(eligible, x_ext / rate.clamp(min=1e-300), big)
    cap_scale = cap.amax(dim=1).clamp(min=1.0)                     # (S,)
    eps = torch.finfo(dt).eps
    level_tol = max(_TOL, 32 * eps)

    x = torch.zeros_like(gamma)
    active = eligible.clone()
    saturated = cap <= _TOL * cap_scale[:, None]
    frozen = torch.zeros_like(cap)
    level = torch.zeros_like(cap_scale)
    for _ in range(r_cnt + 1):
        rate_a = torch.where(active, rate, zero)
        slope_tot = _contract(rate_a, demands)                     # (S, R)
        can_bind = ~saturated & (slope_tot > _TOL)
        go = active.any(dim=0) & can_bind.any(dim=1)               # (S,)
        if not bool(go.any()):
            break

        def usage_at(lvl):
            return frozen + _contract(
                rate_a * (lvl[None] - floor).clamp(min=0.0), demands)

        hi0 = torch.maximum(torch.where(active, floor, zero).amax(dim=0),
                            level)
        head = (cap - usage_at(hi0)).clamp(min=0.0)
        step_up = torch.where(can_bind, head / slope_tot.clamp(min=1e-300),
                              big).amin(dim=1)
        lo, hi = level, hi0 + step_up
        for _ in range(steps):
            inside = (active & (floor > lo[None])
                      & (floor < hi[None])).any(dim=0) & go
            if not bool(inside.any()):
                break
            mid = 0.5 * (lo + hi)
            crossed = torch.where(can_bind, usage_at(mid) - cap,
                                  -torch.ones_like(cap)).amax(dim=1) >= 0
            lo = torch.where(inside & ~crossed, mid, lo)
            hi = torch.where(inside & crossed, mid, hi)
        seg_slope = _contract(rate_a * (floor <= lo[None]), demands)
        u_lo = usage_at(lo)
        root = lo[:, None] + (cap - u_lo).clamp(min=0.0) \
            / seg_slope.clamp(min=1e-300)
        root = torch.where(seg_slope > _TOL, root, big)
        root = torch.where(u_lo >= cap, lo[:, None], root)
        best = torch.where(can_bind, torch.minimum(root, hi[:, None]),
                           big).amin(dim=1)
        best = torch.maximum(best, level)
        u = usage_at(best)
        lslope = _contract(rate_a * (floor <= best[None]), demands)
        bind = can_bind & (cap - u <= lslope * level_tol
                           + 32 * eps * cap_scale[:, None])
        new_x = torch.where(active,
                            rate_a * (best[None] - floor).clamp(min=0.0), x)
        newly = active & ((demands.to(dt) @ bind.T.to(dt)) > 0)
        new_frozen = frozen + _contract(torch.where(newly, new_x, zero),
                                        demands)
        x = torch.where(go[None], new_x, x)
        active = torch.where(go[None], active & ~newly, active)
        saturated = torch.where(go[:, None], saturated | bind, saturated)
        frozen = torch.where(go[:, None], new_frozen, frozen)
        level = torch.where(go, best, level)
    return x


def _fill_one_server_tdm_bisect(demands, phi, gamma, x_ext):
    """Sort-free TDM fill (port of
    ``psdsf_jax._fill_one_server_tdm_bisect``): one bisection on the
    virtual time-share resource, finished by the exact segment root."""
    del demands
    dt = gamma.dtype
    steps = _bisect_steps(dt)
    eligible = gamma > 0
    zero, big = _zero(gamma), _big(gamma)
    rate = torch.where(eligible, phi[:, None], zero)
    floor = torch.where(eligible,
                        x_ext / (phi[:, None] * gamma).clamp(min=1e-300), big)
    has = eligible.any(dim=0)
    fmax = torch.where(eligible, floor, zero).amax(dim=0)
    hi = fmax + 1.0 / rate.sum(dim=0).clamp(min=1e-300)
    lo = torch.zeros_like(hi)
    for _ in range(steps):
        inside = (eligible & (floor > lo[None]) & (floor < hi[None])).any(0)
        if not bool(inside.any()):
            break
        mid = 0.5 * (lo + hi)
        crossed = (rate * (mid[None] - floor).clamp(min=0.0)).sum(0) >= 1.0
        lo = torch.where(inside & ~crossed, mid, lo)
        hi = torch.where(inside & crossed, mid, hi)
    seg_slope = (rate * (floor <= lo[None])).sum(dim=0)
    u_lo = (rate * (lo[None] - floor).clamp(min=0.0)).sum(dim=0)
    root = lo + (1.0 - u_lo).clamp(min=0.0) / seg_slope.clamp(min=1e-300)
    level = torch.where(seg_slope > _TOL, torch.minimum(root, hi), hi)
    return torch.where(eligible & has[None],
                       phi[:, None] * gamma
                       * (level[None] - floor).clamp(min=0.0), zero)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def _solve_core_torch(demands, capacities, weights, gamma, x0, mode,
                      max_rounds, tol, servers=None, alpha0=1.0,
                      fill="event", round_mode="gauss",
                      cluster_fill=fill_cluster):
    """The damped sweep to a fixed point (port of ``psdsf_jax._solve_core``
    without its Anderson branch). All tensors share one dtype and device.

    ``servers`` (int tensor or sequence) restricts each round to those
    servers. ``round_mode="jacobi"`` starts pre-damped (alpha <= 0.5). The
    alpha-normalized stall schedule shrinks alpha by 0.7 (down to 0.01)
    whenever resid/alpha stops falling by 10% after round 3.
    ``cluster_fill`` is the Jacobi bisect round's whole-cluster fill; the
    solve always uses ``ops.fill_cluster``, and only comparisons pass its
    plain twin. Returns (x (N, K), rounds, residual), the residual a 0-dim
    tensor; the loop reads one scalar back per round to decide whether to
    go on.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be 'rdm' or 'tdm': {mode!r}")
    if fill not in FILL_ENGINES:
        raise ValueError(f"fill must be 'event' or 'bisect': {fill!r}")
    if round_mode not in ROUNDS:
        raise ValueError(f"round must be 'gauss' or 'jacobi': {round_mode!r}")
    dt, dev = x0.dtype, x0.device
    k = gamma.shape[1]
    scale = gamma.max() if gamma.numel() else torch.zeros((), dtype=dt,
                                                         device=dev)
    limit = tol * scale.clamp(min=1.0)
    sweep = (torch.arange(k, device=dev) if servers is None
             else torch.as_tensor(servers, device=dev).long())

    def fill_servers(cols, x_ext):
        if mode == "rdm":
            f = (_fill_one_server_rdm_bisect if fill == "bisect"
                 else _fill_one_server_rdm)
            return f(capacities[cols], demands, weights, gamma[:, cols], x_ext)
        f = (_fill_one_server_tdm_bisect if fill == "bisect"
             else _fill_one_server_tdm)
        return f(demands, weights, gamma[:, cols], x_ext)

    if round_mode == "jacobi":
        alpha0 = min(alpha0, 0.5)

        def one_round(x, alpha):
            x_ext = (x.sum(dim=1, keepdim=True) - x)[:, sweep]
            if fill == "bisect":
                xi = cluster_fill(capacities[sweep], demands, weights,
                                  gamma[:, sweep], x_ext, mode=mode)
            else:
                xi = fill_servers(sweep, x_ext)
            x = x.clone()
            x[:, sweep] = (1.0 - alpha) * x[:, sweep] + alpha * xi
            return x
    else:
        order = sweep.tolist()

        def one_round(x, alpha):
            x = x.clone()
            for i in order:
                x_ext = x.sum(dim=1) - x[:, i]
                xi = fill_servers([i], x_ext[:, None])[:, 0]
                x[:, i] = (1.0 - alpha) * x[:, i] + alpha * xi
            return x

    x = x0
    rounds = 0
    prev_norm = torch.full((), float("inf"), dtype=dt, device=dev)
    alpha = torch.full((), alpha0, dtype=dt, device=dev)
    resid = torch.full((), float("inf"), dtype=dt, device=dev)
    while rounds < max_rounds and bool(resid > limit):
        x_new = one_round(x, alpha)
        resid = (x_new - x).abs().amax() if x.numel() else resid.new_zeros(())
        # stall detection on the alpha-normalized residual: on a limit
        # cycle resid ~ alpha * amplitude, so resid/alpha stays flat
        norm = resid / alpha
        if rounds >= 3:
            stall = (norm > 0.9 * prev_norm) & (alpha > 0.01)
            alpha = torch.where(stall, alpha * 0.7, alpha)
        prev_norm = norm
        x = x_new
        rounds += 1
    return x, rounds, resid


def _solve_dtype(demands) -> torch.dtype:
    """The reference's rule: float64 demands solve in float64, anything
    else in float32."""
    f64 = (demands.dtype == torch.float64 if isinstance(demands, torch.Tensor)
           else np.asarray(demands).dtype == np.float64)
    return torch.float64 if f64 else torch.float32


def psdsf_solve_torch(demands, capacities, weights, gamma, *, x0=None,
                      mode: str = "rdm", max_rounds: int = 256,
                      tol: float = 1e-6, placement: str = "level",
                      fill: str = "event", round: str = "gauss",
                      layout: str = "dense", accel: str = "none",
                      device: DeviceLike = None):
    """Solve PS-DSF on ``device`` (default ``cuda``). Returns (x (N, K),
    rounds, residual) with x and the residual as tensors on that device.

    Inputs are tensors or numpy arrays: demands (N, R), capacities (K, R),
    weights (N,), gamma (N, K) (from :func:`gamma.gamma_matrix`), optional
    warm start ``x0`` (N, K) — a fixed point from the JAX reference
    included. Float64 demands solve in float64, anything else in float32.
    ``placement="lexmm"`` is the identity on the level solve, as in the
    reference; the other axes are validated by :func:`check_axes`.
    """
    check_axes(mode=mode, placement=placement, fill=fill, round=round,
               layout=layout, accel=accel)
    dev = resolve_device(device)
    dt = _solve_dtype(demands)

    demands, capacities, weights, gamma = (
        to_device(a, dev, dt) for a in (demands, capacities, weights, gamma))
    n, k = gamma.shape
    x0 = torch.zeros((n, k), dtype=dt, device=dev) if x0 is None \
        else to_device(x0, dev, dt)
    return _solve_core_torch(demands, capacities, weights, gamma, x0, mode,
                             max_rounds, tol, fill=fill, round_mode=round)


def solve_psdsf_rdm_torch(problem: AllocationProblem, x0=None,
                          max_rounds: int = 64, fill: str = "event",
                          round: str = "gauss", accel: str = "none",
                          device: DeviceLike = None) -> Allocation:
    """PS-DSF under resource-division multiplexing on ``device``; returns
    the ``Allocation`` container (float64 host x)."""
    return _solve_problem(problem, "rdm", x0, max_rounds, fill, round, accel,
                          device)


def solve_psdsf_tdm_torch(problem: AllocationProblem, x0=None,
                          max_rounds: int = 64, fill: str = "event",
                          round: str = "gauss", accel: str = "none",
                          device: DeviceLike = None) -> Allocation:
    """PS-DSF under time-division multiplexing on ``device``."""
    return _solve_problem(problem, "tdm", x0, max_rounds, fill, round, accel,
                          device)


def _solve_problem(problem, mode, x0, max_rounds, fill, round, accel,
                   device: Optional[DeviceLike]) -> Allocation:
    x, _, _ = psdsf_solve_torch(
        problem.demands, problem.capacities, problem.weights,
        gamma_matrix(problem), x0=x0, mode=mode, max_rounds=max_rounds,
        fill=fill, round=round, accel=accel, device=device)
    return Allocation(problem, x.double().cpu().numpy())
