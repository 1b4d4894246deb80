"""The paper's Section II baselines on tensors: the port of
``repro/core/baselines_jax.py``, with its own host copies of what it needs
from ``repro/core/baselines.py``.

C-DRFH, TSF and CDRF are weighted max-min level fills whose level rate is
a server-independent score weight w_n on the user's eligible servers: the
PS-DSF sweep with ``gamma[n, i]`` replaced by the (N, K) level-rate matrix.
So at ``placement="level"`` they run the port's PS-DSF cores in RDM
(``psdsf_torch._solve_core_torch`` / ``_solve_core_bucketed_torch``) with
the acceptance band on the per-server gamma scale, and with
``fill="bisect", round="jacobi"`` every round goes through the Hopper
``psdsf_fill`` kernel (``psdsf_fill_bucketed`` on the bucketed layout).
``placement="headroom"`` is the routed global fill
(``_routed_fill_core_torch``): every user's level rises together, split
across its eligible servers in proportion to their headroom for its demand
mix, re-derived at each saturation event; plain torch, as the reference
leaves it to jnp outside any kernel.

DRF on the pooled cluster and the uniform split are host closed forms,
copied here under names of their own. ``placement="lexmm"`` runs the exact
flow router on the host (``flowrouter.lexmm_route_np``, scipy LP
certificates), as the reference's ``solve_baseline_jax`` does: only that
Allocation-level entry takes it, and the array-level entries reject it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from .flowrouter import lexmm_route_np
from .gamma import gamma_matrix, gamma_matrix_torch
from .layout import BucketedLayout, resolve_layout
from .psdsf_torch import (_BIG, _TOL, ACCEL_ENGINES, _check_buckets,
                          _solve_core_bucketed_torch, _solve_core_torch,
                          _solve_dtype, check_axes)
from .solveinfo import SolveInfo, fill_iter_budget, stranded_fraction
from .types import Allocation, AllocationProblem

#: mechanisms expressible as a score-weighted level fill
LEVEL_FILL_MECHANISMS = ("cdrfh", "tsf", "cdrf")
#: midpoint corrector passes of the routed fill between saturation events
#: (``placement.ROUTED_FILL_CORRECTORS``)
ROUTED_FILL_CORRECTORS = 2


def _unknown_mechanism(mechanism: str) -> ValueError:
    return ValueError(f"unknown level-fill mechanism {mechanism!r}; "
                      f"expected one of {LEVEL_FILL_MECHANISMS}")


# ---------------------------------------------------------------------------
# level rates: host copies (baselines.py) and the tensor twin
# ---------------------------------------------------------------------------

def _gamma_unconstrained(problem: AllocationProblem) -> np.ndarray:
    """(N, K) gamma ignoring eligibility (capacity-zero servers still 0)."""
    d, c = problem.demands, problem.capacities
    with np.errstate(divide="ignore"):
        ratio = c[None, :, :] / np.where(d > 0, d, np.inf)[:, None, :]
    ratio = np.where(d[:, None, :] > 0, ratio, np.inf)
    g = ratio.min(axis=2)
    return np.where(np.isfinite(g), g, 0.0)


def score_weights_np(problem: AllocationProblem, mechanism: str
                     ) -> np.ndarray:
    """The per-user score weight w_n defining each baseline's level:
    C-DRFH 1 / (max_r d[n, r] / pooled c[r]); TSF gamma_n summed over all
    servers ignoring eligibility; CDRF gamma_n summed honoring it."""
    if mechanism == "cdrfh":
        pooled = problem.capacities.sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            maxd = np.max(
                np.where(problem.demands > 0,
                         problem.demands / np.maximum(pooled[None, :], 1e-300),
                         0.0), axis=1)
        return np.where(maxd > 0, 1.0 / np.maximum(maxd, 1e-300), 0.0)
    if mechanism == "tsf":
        return _gamma_unconstrained(problem).sum(axis=1)
    if mechanism == "cdrf":
        return gamma_matrix(problem).sum(axis=1)
    raise _unknown_mechanism(mechanism)


def level_rate_matrix_np(problem: AllocationProblem, mechanism: str,
                         gamma: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, K) level-rate matrix on the host: w_n on every server where the
    user's gamma is positive, else 0. Pass a precomputed
    ``gamma_matrix(problem)`` to skip recomputing it."""
    w = score_weights_np(problem, mechanism)
    g = gamma_matrix(problem) if gamma is None else gamma
    return np.where(g > 0, w[:, None], 0.0)


def level_rate_matrix_torch(demands, capacities, eligibility,
                            mechanism: str):
    """Tensor twin of :func:`level_rate_matrix_np` (port of
    ``baselines_jax.level_rate_matrix_jnp``) on demands (N, R), capacities
    (K, R) and eligibility (N, K) of one dtype and device."""
    g = gamma_matrix_torch(demands, capacities, eligibility)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    if mechanism == "cdrfh":
        pooled = capacities.sum(dim=0)
        big = torch.full((), _BIG, dtype=g.dtype, device=g.device)
        frac = torch.where(demands > 0, torch.where(
            pooled[None, :] > 0,
            demands / pooled.clamp(min=1e-300)[None, :], big), zero)
        maxd = frac.amax(dim=1)
        w = torch.where(maxd > 0, 1.0 / maxd.clamp(min=1e-300), zero)
    elif mechanism == "tsf":
        w = gamma_matrix_torch(demands, capacities,
                               torch.ones_like(eligibility)).sum(dim=1)
    elif mechanism == "cdrf":
        w = g.sum(dim=1)
    else:
        raise _unknown_mechanism(mechanism)
    return torch.where(g > 0, w[:, None], zero)


def _gamma_scale_torch(demands, capacities, level_gamma):
    """The per-server monopolization scale of the acceptance band: gamma's
    max over the level rates' support (the level rates sum gamma over
    servers, so their own max would loosen the band ~linearly with K)."""
    g = gamma_matrix_torch(demands, capacities,
                           (level_gamma > 0).to(demands.dtype))
    return g.max()


# ---------------------------------------------------------------------------
# the routed global fill (headroom placement)
# ---------------------------------------------------------------------------

def _routed_fill_core_torch(demands, capacities, weights, level_gamma,
                            correctors=ROUTED_FILL_CORRECTORS):
    """Headroom placement for the global-share mechanisms (port of
    ``baselines_jax._routed_fill_core``): all users' levels rise together,
    each user's rate split across its eligible servers in proportion to
    their headroom for its demand mix, the split re-derived at every
    saturation event after ``correctors`` midpoint passes. At most
    K*R + N + 1 events, each saturating a (server, resource) pair or
    freezing a user; one flag is read back an event to decide whether to
    go on. All tensors share one dtype and device. Returns (x (N, K),
    events, residual 0-dim tensor of 0.0): one-shot exact, nothing
    iterates."""
    n, r_cnt = demands.shape
    k = capacities.shape[0]
    dt, dev = demands.dtype, demands.device
    zero = torch.zeros((), dtype=dt, device=dev)
    big = torch.full((), _BIG, dtype=dt, device=dev)
    cap = capacities
    eligible = level_gamma > 0
    cap_max = cap.max().clamp(min=1.0) if cap.numel() else torch.ones(
        (), dtype=dt, device=dev)
    cap_scale = torch.maximum(cap, (cap_max * 1e-9).clamp(min=1e-12))
    dem_pos = demands[:, None, :] > 0
    dem_safe = demands.clamp(min=1e-300)[:, None, :]

    def room(free):
        ratio = torch.where(dem_pos, free[None, :, :] / dem_safe, big)
        return torch.where(eligible, ratio.amin(dim=2), zero).clamp(min=0.0)

    def split_by(h, active):
        hsum = h.sum(dim=1, keepdim=True)
        s = torch.where(hsum > 0, h / hsum.clamp(min=1e-300), zero)
        return s * active[:, None]

    def rates_and_slope(split):
        task_rate = weights[:, None] * level_gamma * split
        return task_rate, torch.einsum("nk,nr->kr", task_rate, demands)

    def slope_floor(slope):
        return slope.amax().clamp(min=0.0).clamp(min=1e-300)

    def next_step(slope, free):
        return torch.where(slope > _TOL * slope_floor(slope),
                           free / slope.clamp(min=1e-300), big).amin()

    h_scale = room(cap).amax().clamp(min=0.0).clamp(min=1e-300)
    x = torch.zeros((n, k), dtype=dt, device=dev)
    free = cap.clone()
    active = eligible.any(dim=1)
    events = 0
    go = bool(active.any())
    while go and events < k * r_cnt + n + 1:
        h = room(free)
        active = active & (h.sum(dim=1) > _TOL * h_scale)
        split = split_by(h, active)
        for _ in range(correctors):
            _, slope = rates_and_slope(split)
            dl = next_step(slope, free)
            dl = torch.where(dl < _BIG * 0.5, dl, zero)
            h_mid = room((free - slope * (0.5 * dl)).clamp(min=0.0))
            split = split_by(h_mid, active)
        task_rate, slope = rates_and_slope(split)
        dl = next_step(slope, free)
        ok = active.any() & (dl < _BIG * 0.5)
        dl = torch.where(ok, dl.clamp(min=0.0), zero)
        x = x + task_rate * dl
        free = (free - slope * dl).clamp(min=0.0)
        sat = (free <= _TOL * cap_scale) & (slope > _TOL * slope_floor(slope))
        free = torch.where(sat, zero, free)
        active = active & ok
        events += 1
        go = bool(active.any())
    return x, events, zero


def _reject_lexmm_torch(placement: str) -> None:
    """The traced baseline entries' gate: lexmm's level increments are
    certified by host-side LP solves, with nothing to run on tensors."""
    if placement == "lexmm":
        raise ValueError(
            "placement='lexmm' has no traced baseline fill: its level "
            "increments are certified by host-side LP solves")


def _reject_routed_bucketed(placement: str, layout: str) -> None:
    if placement in ("headroom", "lexmm") and layout == "bucketed":
        raise ValueError(
            f"layout='bucketed' needs the per-server sweep; placement "
            f"{placement!r} is a one-shot routed fill: use layout='dense'")


def _routed(demands, capacities, weights, level_gamma, accel):
    """The routed fill as a sweep's output tuple: (x, events, 0.0), plus
    zero Anderson counters under ``accel="anderson"``."""
    out = _routed_fill_core_torch(demands, capacities, weights, level_gamma)
    if accel == "anderson":        # one-shot fill: nothing to accelerate
        out = out + (0, 0)
    return out


def _prepare(device, demands, capacities, weights, level_gamma, x0):
    dev = resolve_device(device)
    dt = _solve_dtype(demands)
    arrays = [to_device(a, dev, dt)
              for a in (demands, capacities, weights, level_gamma)]
    arrays.append(torch.zeros_like(arrays[3]) if x0 is None
                  else to_device(x0, dev, dt))
    return arrays


def baseline_solve_torch(demands, capacities, weights, level_gamma, *,
                         x0=None, max_rounds: int = 256, tol: float = 1e-6,
                         placement: str = "level", fill: str = "event",
                         round: str = "gauss", layout: str = "dense",
                         buckets=None, accel: str = "none",
                         device: DeviceLike = None):
    """Solve one baseline fill on ``device`` (default ``cuda``); the port
    of ``baselines_jax.baseline_solve_jax``. Returns (x (N, K), rounds,
    residual), plus (accel_hits, accel_rejects) under
    ``accel="anderson"``.

    ``level_gamma`` is the (N, K) level-rate matrix
    (:func:`level_rate_matrix_np` / :func:`level_rate_matrix_torch`); the
    other inputs and axes are ``psdsf_torch.psdsf_solve_torch``'s, the
    sweep always in RDM. ``placement="headroom"`` runs the routed global
    fill instead (``x0``, the sweep axes and Anderson are then unused, and
    ``rounds`` counts its events; the bucketed layout is rejected);
    ``"lexmm"`` and ``"bestfit"`` are rejected, as on the reference's
    jitted entry.
    """
    check_axes(placement=placement, fill=fill, round=round, layout=layout,
               accel=accel)
    _reject_lexmm_torch(placement)
    _check_buckets(layout, buckets)
    _reject_routed_bucketed(placement, layout)
    d, c, w, lg, x0 = _prepare(device, demands, capacities, weights,
                               level_gamma, x0)
    if placement == "headroom":
        return _routed(d, c, w, lg, accel)
    kw = dict(scale=_gamma_scale_torch(d, c, lg), fill=fill,
              round_mode=round, accel=accel)
    if layout == "bucketed":
        idx, mask = (to_device(b, d.device) for b in buckets)
        return _solve_core_bucketed_torch(d, c, w, lg, x0, idx, mask, "rdm",
                                          max_rounds, tol, **kw)
    return _solve_core_torch(d, c, w, lg, x0, "rdm", max_rounds, tol, **kw)


def baseline_solve_batched_torch(demands, capacities, weights, level_gamma,
                                 *, x0=None, max_rounds: int = 256,
                                 tol: float = 1e-6, placement: str = "level",
                                 fill: str = "event", round: str = "gauss",
                                 layout: str = "dense", buckets=None,
                                 accel: str = "none",
                                 device: DeviceLike = None):
    """Solve B independent baseline fills on ``device`` (default
    ``cuda``); the port of ``baselines_jax.baseline_solve_batched``.

    Shapes as ``batched.psdsf_solve_batched``: demands (B, N, R),
    capacities (B, K, R), weights (B, N), level_gamma (B, N, K), optional
    x0 (B, N, K); pad with ``batched.batch_problems`` and
    :func:`batch_level_rates_torch` (padding is inert). The problems go
    through the cores one after another, each with its own gamma scale and
    round count. Returns (x (B, N, K), rounds (B,), residual (B,)), plus
    per-problem Anderson counters; the axes as in
    :func:`baseline_solve_torch`, bucketed ``buckets`` per problem
    ((B, K, Bmax) stacks).
    """
    from .batched import _stack

    check_axes(placement=placement, fill=fill, round=round, layout=layout,
               accel=accel)
    _reject_lexmm_torch(placement)
    _check_buckets(layout, buckets)
    _reject_routed_bucketed(placement, layout)
    d, c, w, lg, x0 = _prepare(device, demands, capacities, weights,
                               level_gamma, x0)
    if layout == "bucketed":
        idx, mask = (to_device(b, d.device) for b in buckets)
    outs = []
    for j in range(lg.shape[0]):
        if placement == "headroom":
            outs.append(_routed(d[j], c[j], w[j], lg[j], accel))
            continue
        kw = dict(scale=_gamma_scale_torch(d[j], c[j], lg[j]), fill=fill,
                  round_mode=round, accel=accel)
        if layout == "bucketed":
            outs.append(_solve_core_bucketed_torch(
                d[j], c[j], w[j], lg[j], x0[j], idx[j], mask[j], "rdm",
                max_rounds, tol, **kw))
        else:
            outs.append(_solve_core_torch(d[j], c[j], w[j], lg[j], x0[j],
                                          "rdm", max_rounds, tol, **kw))
    return _stack(outs)


def batch_level_rates_torch(problems: Sequence[AllocationProblem],
                            mechanism: str, dtype=np.float32,
                            device: DeviceLike = None) -> torch.Tensor:
    """Per-problem level-rate matrices zero-padded to a common (N, K) and
    stacked as a (B, N, K) tensor of ``dtype`` on ``device`` (default
    ``cuda``): the level-rate companion of ``batched.batch_problems``
    (padding is inert: rate 0 never fills)."""
    dev = resolve_device(device)
    n_max = max(p.num_users for p in problems)
    k_max = max(p.num_servers for p in problems)
    lg = np.zeros((len(problems), n_max, k_max), dtype)
    for j, p in enumerate(problems):
        lg[j, :p.num_users, :p.num_servers] = level_rate_matrix_np(
            p, mechanism)
    return to_device(lg, dev)


def solve_baseline_torch(problem: AllocationProblem, mechanism: str,
                         x0=None, max_rounds: int = 256, tol: float = 1e-6,
                         loose_tol: float = 5e-3, placement: str = "level",
                         fill: str = "event", round: str = "gauss",
                         layout: str = "auto", accel: str = "none",
                         device: DeviceLike = None
                         ) -> Tuple[Allocation, SolveInfo]:
    """Solve ``problem`` under the baseline ``mechanism`` ("cdrfh", "tsf",
    "cdrf") on ``device`` (default ``cuda``); the port of
    ``baselines_jax.solve_baseline_jax``. Returns the ``(Allocation,
    SolveInfo)`` pair with every field the reference fills.

    ``layout`` resolves on the host from the level rates' support, as in
    ``engine.solve``; the routed ``placement="headroom"`` fill runs dense
    (an explicit ``"bucketed"`` is rejected), reports its events as rounds,
    no fill engine and no fill iterations. ``placement="lexmm"`` runs the
    exact flow router on the host (``flowrouter.lexmm_route_np``): dense
    only, as in the reference, with its stages as rounds, a zero residual
    and no fill engine; the router's LP counters stay at 0, as on the
    reference's jitted backend. ``device`` is checked all the same, though
    no LP runs there.
    """
    dev = resolve_device(device)
    g = gamma_matrix(problem)      # computed once: level rates AND scale
    lg = level_rate_matrix_np(problem, mechanism, gamma=g)
    if accel not in ACCEL_ENGINES:
        raise ValueError(f"accel must be one of {ACCEL_ENGINES}: {accel!r}")
    swept = placement not in ("headroom", "lexmm")
    buckets, bucket_max = None, 0
    if swept:
        resolved = resolve_layout(layout, support=lg)
        if resolved == "bucketed":
            blayout = BucketedLayout.from_support(lg > 0)
            buckets = (to_device(blayout.indices, dev),
                       to_device(blayout.mask, dev))
            bucket_max = blayout.bucket_max
    else:
        _reject_routed_bucketed(placement, layout)
        resolved = "dense"
    if placement == "lexmm":
        x, stages = lexmm_route_np(problem, lg)
        return (Allocation(problem, x),
                SolveInfo(stages, True, 0.0, placement="lexmm",
                          fill_engine="", accel=accel,
                          stranded_frac=stranded_fraction(problem, x,
                                                          gamma=g)))
    out = baseline_solve_torch(
        problem.demands, problem.capacities, problem.weights, lg, x0=x0,
        max_rounds=max_rounds, tol=tol, placement=placement, fill=fill,
        round=round, layout=resolved, buckets=buckets, accel=accel,
        device=dev)
    rounds, resid = int(out[1]), float(out[2])
    hits, rejects = ((int(out[3]), int(out[4])) if accel == "anderson"
                     else (0, 0))
    x = out[0].double().cpu().numpy()
    swept = placement != "headroom"       # routed fill: no per-server fill
    return (Allocation(problem, x),
            SolveInfo.from_residual(
                rounds, resid, float(g.max(initial=1.0)), tol, loose_tol,
                placement=placement,
                stranded_frac=stranded_fraction(problem, x, gamma=g),
                fill_engine=fill if swept else "",
                fill_iters=(rounds * problem.num_servers
                            * fill_iter_budget(problem.num_resources, "rdm",
                                               fill) if swept else 0),
                layout=resolved, bucket_max=bucket_max, accel=accel,
                accel_hits=hits, accel_rejects=rejects))


# ---------------------------------------------------------------------------
# closed forms: DRF on the pooled cluster, the uniform split (host copies)
# ---------------------------------------------------------------------------

def pooled_relaxation(problem: AllocationProblem) -> AllocationProblem:
    """The single-server full-substitutability relaxation DRF solves on:
    one virtual server holding the cluster's summed capacities."""
    return AllocationProblem(
        demands=problem.demands,
        capacities=problem.capacities.sum(axis=0, keepdims=True),
        weights=problem.weights)


def drf_pool_totals(problem: AllocationProblem) -> np.ndarray:
    """Original DRF on the pooled capacities: exact event-driven
    progressive filling of all users on one server of capacity
    sum_i c_i. Returns the per-user tasks x_n (N,)."""
    d = problem.demands
    cap = problem.capacities.sum(axis=0)
    phi = problem.weights
    n, r_cnt = d.shape
    with np.errstate(divide="ignore", invalid="ignore"):
        maxd = np.max(d / np.maximum(cap[None, :], 1e-300), axis=1)
    rate = phi / np.maximum(maxd, 1e-300)     # dx/dL, L = dominant share/phi
    active = np.ones(n, dtype=bool)
    x = np.zeros(n)
    usage = np.zeros(r_cnt)
    for _ in range(r_cnt + 1):
        if not active.any():
            break
        slopes = np.einsum("n,nr->r", rate * active, d)
        with np.errstate(divide="ignore", invalid="ignore"):
            lr = np.where(slopes > 1e-300, (cap - usage) / slopes, np.inf)
        r_star = int(np.argmin(lr))
        dl = lr[r_star]
        if not np.isfinite(dl):
            break
        x = x + rate * active * dl
        usage = usage + slopes * dl
        sat = lr <= lr[r_star] + 1e-9
        active &= ~(active & (d[:, sat].sum(axis=1) > 0))
    return x


def drf_pooled_allocation(problem: AllocationProblem
                          ) -> Tuple[Allocation, SolveInfo]:
    """Classic DRF on the pooled cluster: the ``Allocation`` lives on the
    pooled relaxation (one virtual server, x of shape (N, 1)), with its
    stranded fraction on the returned ``SolveInfo``."""
    pooled = pooled_relaxation(problem)
    x = drf_pool_totals(problem)[:, None]
    return (Allocation(pooled, x),
            SolveInfo(1, True, 0.0, stranded_frac=stranded_fraction(pooled,
                                                                    x)))


def uniform_share_allocation(problem: AllocationProblem
                             ) -> Tuple[Allocation, SolveInfo]:
    """Every user gets phi_n / sum_m phi_m of each resource on every
    server (the sharing-incentive reference point; ineligible shares are
    wasted), with its stranded fraction."""
    g = gamma_matrix(problem)
    share = problem.weights / problem.weights.sum()
    x = g * share[:, None]
    return (Allocation(problem, x),
            SolveInfo(1, True, 0.0, stranded_frac=stranded_fraction(problem,
                                                                    x)))

