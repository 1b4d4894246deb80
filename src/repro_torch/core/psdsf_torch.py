"""PS-DSF solve on tensors (RDM and TDM): the port of
``repro/core/psdsf_jax.py``'s single-problem solve, dense and bucketed.

Same math as the reference: every round rebuilds each server's fill by
water-filling its users up to the first saturated resource, damped, until
the residual passes ``tol * scale`` or ``max_rounds`` is spent.

* ``round="gauss"`` refills the servers one after another (Gauss-Seidel),
  each against the current usage, with one of the four per-server fills
  (``fill="event"``: sorted saturation-event scan; ``fill="bisect"``: the
  sort-free bisection with an exact segment root). These stay plain torch,
  as the reference leaves them to jnp outside any Pallas kernel.
* ``round="jacobi"`` refills every server at once against the previous
  round's usage. With ``fill="bisect"`` that whole-cluster fill is a Hopper
  kernel for CUDA tensors (its plain version for CPU tensors):
  ``kernels/psdsf_fill/ops.fill_cluster`` on the dense layout,
  ``kernels/psdsf_fill_bucketed/ops.fill_cluster_bucketed`` on the bucketed
  one. With ``fill="event"`` it is the event fill batched over the server
  axis.
* ``layout="bucketed"`` (``_solve_core_bucketed_torch``) works on the
  per-server eligibility buckets of a ``layout.BucketedLayout``: gathered
  (K, Bmax[, R]) state, row sums re-derived by scatter-add every round.
* ``accel="anderson"`` wraps either core's damped sweep in safeguarded
  Anderson mixing (``_anderson_rounds_torch``).

The per-server fills are written for a batch of S servers at once (columns
of (N, S) tensors): Gauss-Seidel calls them with S = 1, and the bucketed
core passes each server its own (Bmax, S, R) demand rows. The reference's
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
from ..kernels.psdsf_fill_bucketed.ops import fill_cluster_bucketed
from .gamma import gamma_matrix
from .layout import LAYOUTS
from .solveinfo import BISECT_STEPS, BISECT_STEPS_F32, FILL_ENGINES
from .types import Allocation, AllocationProblem

_BIG = 1e30
_TOL = 1e-9

#: history depth of the Anderson mixer (``placement.ANDERSON_MEMORY`` in
#: the reference)
ANDERSON_MEMORY = 5
PLACEMENTS = ("level", "headroom", "bestfit", "lexmm")
ACCEL_ENGINES = ("none", "anderson")
ROUNDS = ("gauss", "jacobi")
MODES = ("rdm", "tdm")


class UnknownNameError(KeyError, ValueError):
    """An unknown placement strategy or mechanism name. The reference's
    registries raise ``KeyError`` for these; deriving from ``ValueError``
    as well keeps the port's other axis checks' class. ``str()`` is the
    message itself, not ``KeyError``'s quoted repr."""

    def __str__(self) -> str:
        return str(self.args[0]) if self.args else ""


def check_placement(placement: str) -> None:
    """``UnknownNameError`` for a placement strategy the reference does
    not register (its ``get_placement`` raises ``KeyError``)."""
    if placement not in PLACEMENTS:
        raise UnknownNameError(
            f"unknown placement strategy {placement!r}; registered: "
            f"{', '.join(sorted(PLACEMENTS))}")


def check_axes(*, mode: str = "rdm", placement: str = "level",
               fill: str = "event", round: str = "gauss",
               layout: str = "dense", accel: str = "none") -> None:
    """Validate the engine axes: ``UnknownNameError`` for an unknown
    placement, ``ValueError`` for every other value the reference rejects
    on its jitted path."""
    check_placement(placement)
    for axis, value, allowed in (("mode", mode, MODES),
                                 ("fill", fill, FILL_ENGINES),
                                 ("round", round, ROUNDS),
                                 ("layout", layout, LAYOUTS),
                                 ("accel", accel, ACCEL_ENGINES)):
        if value not in allowed:
            raise ValueError(f"{axis} must be one of {allowed}: {value!r}")
    if placement == "bestfit":
        raise ValueError("placement 'bestfit' has no device mirror (the "
                         "reference runs it on its numpy engine only)")


def _check_buckets(layout: str, buckets) -> None:
    """The reference's gate for the bucketed layout's arguments:
    ``psdsf_solve_torch`` takes a concrete ``"dense"``/``"bucketed"``
    (``"auto"`` is resolved host-side by ``engine.solve`` through
    ``layout.resolve_layout``), and ``"bucketed"`` needs the ``(idx,
    mask)`` arrays of a ``layout.BucketedLayout``."""
    if layout not in ("dense", "bucketed"):
        raise ValueError(
            f"psdsf_solve_torch takes layout='dense'|'bucketed' (resolve "
            f"'auto' host-side, e.g. via layout.resolve_layout): {layout!r}")
    if layout == "bucketed" and buckets is None:
        raise ValueError("layout='bucketed' needs buckets=(idx, mask) from "
                         "a BucketedLayout (host-built)")


def _bisect_steps(dtype) -> int:
    return BISECT_STEPS if dtype == torch.float64 else BISECT_STEPS_F32


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _big(t):
    return torch.full((), _BIG, dtype=t.dtype, device=t.device)


def _cols(phi):
    """Per-user weights as (N, S) columns: an (N,) vector broadcasts over
    the servers, an (N, S) matrix (bucketed: each server its own users) is
    taken as it is."""
    return phi[:, None] if phi.dim() == 1 else phi


def _contract(w, demands):
    """(N, S) weights x demands -> (S, R) per-server usage sums. The
    demands are one (N, R) matrix for every server column, or (N, S, R):
    each server its own rows (the bucketed layout)."""
    if demands.dim() == 2:
        return w.T @ demands
    return torch.einsum("ns,nsr->sr", w, demands)


def _demands_any(demands, bind):
    """(N, S): sum_r d[n, (s,) r] * bind[s, r], i.e. > 0 where user n of
    column s demands a resource bound on s."""
    bind = bind.to(demands.dtype)
    if demands.dim() == 2:
        return demands @ bind.T
    return torch.einsum("nsr,sr->ns", demands, bind)


# ---------------------------------------------------------------------------
# the four per-server fills, each over a batch of S servers (columns)
# ---------------------------------------------------------------------------

def _fill_one_server_rdm(cap, demands, phi, gamma, x_ext):
    """Event fill (port of ``psdsf_jax._fill_one_server_rdm``): users are
    sorted by floor once, and each of the R+1 saturation events scans the
    breakpoints for the first crossing level. cap (S, R); demands (N, R)
    or (N, S, R); phi (N,) or (N, S); gamma, x_ext (N, S). Returns the
    (N, S) fill."""
    r_cnt = demands.shape[-1]
    eligible = gamma > 0
    zero, big = _zero(gamma), _big(gamma)
    rate = torch.where(eligible, _cols(phi) * gamma, zero)
    floor = torch.where(eligible, x_ext / rate.clamp(min=1e-300), big)
    order = torch.argsort(floor, dim=0, stable=True)               # (N, S)
    f_s = torch.gather(floor, 0, order)
    rt_s = torch.gather(rate, 0, order)
    dm_s = (demands[order] if demands.dim() == 2 else torch.gather(
        demands, 0, order[..., None].expand(-1, -1, r_cnt)))       # (N, S, R)
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
    phi = _cols(phi)
    rate = torch.where(eligible, phi, zero)                    # d(x/gamma)/dL
    floor = torch.where(eligible,
                        x_ext / (phi * gamma).clamp(min=1e-300), big)
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
                       phi * gamma * (level[None] - floor).clamp(min=0.0),
                       zero)


def _fill_one_server_rdm_bisect(cap, demands, phi, gamma, x_ext):
    """Sort-free fill (port of ``psdsf_jax._fill_one_server_rdm_bisect``):
    per saturation event, bisect the bracket [level, max active floor +
    tightest headroom step] until no active floor lies inside, then take
    the exact linear-segment root. cap (S, R); demands (N, R) or (N, S, R);
    phi (N,) or (N, S); gamma, x_ext (N, S). Returns the (N, S) fill."""
    r_cnt = demands.shape[-1]
    dt = demands.dtype
    steps = _bisect_steps(dt)
    eligible = gamma > 0
    zero, big = _zero(gamma), _big(gamma)
    rate = torch.where(eligible, _cols(phi) * gamma, zero)
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
        newly = active & (_demands_any(demands, bind) > 0)
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
    phi = _cols(phi)
    rate = torch.where(eligible, phi, zero)
    floor = torch.where(eligible,
                        x_ext / (phi * gamma).clamp(min=1e-300), big)
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
                       phi * gamma * (level[None] - floor).clamp(min=0.0),
                       zero)


# ---------------------------------------------------------------------------
# the outer iteration: plain damped rounds, or Anderson-mixed
# ---------------------------------------------------------------------------

def _plain_rounds(one_round, x0, max_rounds, limit, alpha0, stall=True):
    """The damped sweep loop with the alpha-normalized stall schedule:
    ``one_round(x, alpha) -> (x_new, resid)``; alpha shrinks by 0.7 (down
    to 0.01) whenever resid/alpha stops falling by 10% after round 3 (on a
    limit cycle resid ~ alpha * amplitude, so resid/alpha stays flat);
    ``stall=False`` keeps alpha at ``alpha0``. Reads one scalar back per
    round to decide whether to go on. Returns (x, rounds, resid)."""
    dt, dev = x0.dtype, x0.device
    x = x0
    rounds = 0
    prev_norm = torch.full((), float("inf"), dtype=dt, device=dev)
    alpha = torch.full((), alpha0, dtype=dt, device=dev)
    resid = torch.full((), float("inf"), dtype=dt, device=dev)
    while rounds < max_rounds and bool(resid > limit):
        x_new, resid = one_round(x, alpha)
        norm = resid / alpha
        if stall and rounds >= 3:
            stalled = (norm > 0.9 * prev_norm) & (alpha > 0.01)
            alpha = torch.where(stalled, alpha * 0.7, alpha)
        prev_norm = norm
        x = x_new
        rounds += 1
    return x, rounds, resid


def _anderson_rounds_torch(one_round, x0, max_rounds, limit, alpha0,
                          stall=True):
    """Safeguarded limited-memory Anderson mixing over the damped sweep
    (port of ``psdsf_jax._anderson_rounds``): ``one_round(x, alpha) ->
    (x_new, resid)`` applies one full damped sweep and reports its
    residual. After each plain sweep a mixed candidate is extrapolated from
    the rolling (m+1, size) history (m = min(``ANDERSON_MEMORY``, size-1);
    masked difference columns, reduced QR with a diagonal guard on dead
    columns, a triangular solve, clamped at 0) and accepted only when one
    plain sweep from it lowers the residual; a rejected candidate restarts
    the history from the latest plain pair. Both sweeps count as rounds,
    a candidate is tried only while the budget affords its evaluation,
    and alpha follows the plain loop's stall schedule on the counted
    rounds (``stall=False`` keeps it at ``alpha0``). The reference
    evaluates a masked candidate every round; here it is computed only
    when it can be used, with the same results.
    Returns (x, rounds, resid, accel_hits, accel_rejects)."""
    dt, dev = x0.dtype, x0.device
    shape, size = x0.shape, x0.numel()
    m = min(ANDERSON_MEMORY, max(size - 1, 1))
    cols = torch.arange(m, device=dev)
    hf = torch.zeros((m + 1, size), dtype=dt, device=dev)
    hg = torch.zeros_like(hf)
    hlen = hits = rejects = rounds = 0
    x = x0
    prev_norm = torch.full((), float("inf"), dtype=dt, device=dev)
    alpha = torch.full((), alpha0, dtype=dt, device=dev)
    resid = torch.full((), float("inf"), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def push(h, row):
        return torch.cat([h[1:], row.reshape(1, -1)])

    while rounds < max_rounds and bool(resid > limit):
        g_x, resid = one_round(x, alpha)
        hf, hg = push(hf, g_x - x), push(hg, g_x)
        hlen = min(hlen + 1, m + 1)
        rounds += 1
        x = g_x
        if hlen >= 2 and rounds < max_rounds and bool(resid > limit):
            # difference columns over the valid window; older slots are
            # dead columns of exact zeros
            col_ok = (cols >= m + 1 - hlen).to(dt)
            df = (hf[1:] - hf[:-1]).T * col_ok
            dg = (hg[1:] - hg[:-1]).T * col_ok
            q, r = torch.linalg.qr(df)
            diag = r.diagonal().abs()
            ref = diag.max().clamp(min=1e-30)
            r = r + torch.diag(torch.where(diag < 1e-12 * ref, ref, zero))
            theta = torch.linalg.solve_triangular(
                r, (q.T @ hf[-1])[:, None], upper=True)[:, 0]
            cand = (hg[-1] - dg @ theta).clamp(min=0.0).reshape(shape)
            g_c, resid_c = one_round(cand, alpha)
            rounds += 1
            if bool(torch.isfinite(resid_c) & (resid_c < resid)):
                hf, hg = push(hf, g_c - cand), push(hg, g_c)
                hlen = min(hlen + 1, m + 1)
                hits += 1
                x, resid = g_c, resid_c
            else:
                hlen = 1
                rejects += 1
        norm = resid / alpha
        if stall and rounds >= 3:
            stalled = (norm > 0.9 * prev_norm) & (alpha > 0.01)
            alpha = torch.where(stalled, alpha * 0.7, alpha)
        prev_norm = norm
    return x, rounds, resid, hits, rejects


def _outer(one_round, x0, max_rounds, limit, alpha0, accel, stall=True):
    if accel == "anderson":
        return _anderson_rounds_torch(one_round, x0, max_rounds, limit,
                                      alpha0, stall)
    return _plain_rounds(one_round, x0, max_rounds, limit, alpha0, stall)


def _check_core_axes(mode, fill, round_mode, accel):
    if mode not in MODES:
        raise ValueError(f"mode must be 'rdm' or 'tdm': {mode!r}")
    if fill not in FILL_ENGINES:
        raise ValueError(f"fill must be 'event' or 'bisect': {fill!r}")
    if round_mode not in ROUNDS:
        raise ValueError(f"round must be 'gauss' or 'jacobi': {round_mode!r}")
    if accel not in ACCEL_ENGINES:
        raise ValueError(f"accel must be 'none' or 'anderson': {accel!r}")


def _server_fill(mode, fill):
    """The per-server fill of (mode, fill), called as
    ``f(cap, demands, phi, gamma, x_ext)``."""
    if mode == "rdm":
        return (_fill_one_server_rdm_bisect if fill == "bisect"
                else _fill_one_server_rdm)
    f = (_fill_one_server_tdm_bisect if fill == "bisect"
         else _fill_one_server_tdm)
    return lambda cap, demands, phi, gamma, x_ext: f(demands, phi, gamma,
                                                     x_ext)


def _residual_limit(gamma, tol, scale=None):
    """tol x max(1, scale), ``scale`` defaulting to ``gamma.max()`` (the
    baselines pass the per-server gamma scale: their level rates sum gamma
    over servers)."""
    if scale is None:
        scale = gamma.max() if gamma.numel() else torch.zeros(
            (), dtype=gamma.dtype, device=gamma.device)
    scale = torch.as_tensor(scale, dtype=gamma.dtype, device=gamma.device)
    return tol * scale.clamp(min=1.0)


def _sweep(servers, k, dev):
    return (torch.arange(k, device=dev) if servers is None
            else torch.as_tensor(servers, device=dev).long())


# ---------------------------------------------------------------------------
# the solve, dense and bucketed
# ---------------------------------------------------------------------------

def _solve_core_torch(demands, capacities, weights, gamma, x0, mode,
                      max_rounds, tol, servers=None, alpha0=1.0, scale=None,
                      fill="event", round_mode="gauss", accel="none",
                      cluster_fill=fill_cluster, stall=True):
    """The damped sweep to a fixed point on the dense layout (port of
    ``psdsf_jax._solve_core``). All tensors share one dtype and device.

    ``servers`` (int tensor or sequence) restricts each round to those
    servers. ``scale`` overrides the acceptance scale ``gamma.max()``
    (the baselines pass their per-server gamma scale).
    ``round_mode="jacobi"`` starts pre-damped (alpha <= 0.5).
    ``cluster_fill`` is the Jacobi bisect round's whole-cluster fill; the
    solve always uses ``ops.fill_cluster``, and only comparisons pass its
    plain twin. ``stall=False`` turns the stall schedule off
    (:func:`_plain_rounds`). Returns (x (N, K), rounds, residual), the
    residual a 0-dim tensor, plus (accel_hits, accel_rejects) under
    ``accel="anderson"``.
    """
    _check_core_axes(mode, fill, round_mode, accel)
    k = gamma.shape[1]
    limit = _residual_limit(gamma, tol, scale)
    sweep = _sweep(servers, k, x0.device)
    fill_fn = _server_fill(mode, fill)

    def fill_servers(cols, x_ext):
        return fill_fn(capacities[cols], demands, weights, gamma[:, cols],
                       x_ext)

    if round_mode == "jacobi":
        alpha0 = min(alpha0, 0.5)

        def sweep_round(x, alpha):
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

        def sweep_round(x, alpha):
            x = x.clone()
            for i in order:
                x_ext = x.sum(dim=1) - x[:, i]
                xi = fill_servers([i], x_ext[:, None])[:, 0]
                x[:, i] = (1.0 - alpha) * x[:, i] + alpha * xi
            return x

    def one_round(x, alpha):
        x_new = sweep_round(x, alpha)
        resid = (x_new - x).abs().amax() if x.numel() else limit.new_zeros(())
        return x_new, resid

    return _outer(one_round, x0, max_rounds, limit, alpha0, accel, stall)


def _solve_core_bucketed_torch(demands, capacities, weights, gamma, x0, idx,
                               mask, mode, max_rounds, tol, servers=None,
                               alpha0=1.0, scale=None, fill="event",
                               round_mode="gauss", accel="none",
                               cluster_fill=fill_cluster_bucketed,
                               stall=True):
    """The damped sweep on sparse eligibility (port of
    ``psdsf_jax._solve_core_bucketed``).

    ``idx``/``mask`` are a ``layout.BucketedLayout``'s padded (K, Bmax)
    per-server user buckets. The solve works on gathered (K, Bmax[, R])
    state: each server's fill sees only its bucket's rows, and the per-user
    row sums feeding the external usage are re-derived by scatter-add at
    every round start (Gauss-Seidel then adds each server's delta). Padded
    slots carry gamma 0, so they fill to 0 and their deltas are exact
    zeros. The residual is the reference's: the max over the swept slots
    (Jacobi) or the max |delta| (Gauss-Seidel); ``scale`` as in
    :func:`_solve_core_torch`. ``cluster_fill`` is the
    Jacobi bisect round's whole-cluster fill (``fill_cluster_bucketed``;
    only comparisons pass its plain twin); ``stall`` as in
    :func:`_solve_core_torch`. Anderson mixes the packed
    (K, Bmax) state. Returns (x dense (N, K), rounds, residual), plus
    (accel_hits, accel_rejects) under ``accel="anderson"``; x is built by
    scatter-ADD, so a padded slot adds an exact 0.0 wherever it points.
    """
    _check_core_axes(mode, fill, round_mode, accel)
    n, k = gamma.shape
    dt, dev = x0.dtype, x0.device
    limit = _residual_limit(gamma, tol, scale)
    sweep = _sweep(servers, k, dev)
    fill_fn = _server_fill(mode, fill)
    idx = torch.as_tensor(idx, device=dev).long()
    mask = torch.as_tensor(mask, device=dev).bool()
    zero = torch.zeros((), dtype=dt, device=dev)
    gam_b = torch.where(mask, torch.gather(gamma.T, 1, idx), zero)
    dem_b = demands[idx]                                    # (K, Bmax, R)
    phi_b = weights[idx]                                    # (K, Bmax)
    xb0 = torch.where(mask, torch.gather(x0.T, 1, idx), zero)
    flat_idx = idx.reshape(-1)

    def fill_servers(cols, x_ext):
        """Fills of servers ``cols`` from their (S, Bmax) external usage,
        as (S, Bmax): each server's bucket is one column of the fill."""
        return fill_fn(capacities[cols], dem_b[cols].transpose(0, 1),
                       phi_b[cols].T, gam_b[cols].T, x_ext.T).T

    def row_sums(xb):
        return torch.zeros(n, dtype=dt, device=dev).index_add_(
            0, flat_idx, torch.where(mask, xb, zero).reshape(-1))

    if round_mode == "jacobi":
        alpha0 = min(alpha0, 0.5)
        idx_s, mask_s = idx[sweep], mask[sweep]
        swept = (capacities[sweep].contiguous(), dem_b[sweep].contiguous(),
                 phi_b[sweep], gam_b[sweep])

        def one_round(xb, alpha):
            x_ext = row_sums(xb)[idx_s] - xb[sweep]
            if fill == "bisect":
                xi = cluster_fill(*swept, x_ext, mask_s, mode=mode)
            else:
                xi = fill_servers(sweep, x_ext)
            new = (1.0 - alpha) * xb[sweep] + alpha * torch.where(
                mask_s, xi, zero)
            resid = (new - xb[sweep]).abs().amax() if new.numel() else zero
            xb = xb.clone()
            xb[sweep] = new
            return xb, resid
    else:
        order = sweep.tolist()

        def one_round(xb, alpha):
            xsum = row_sums(xb)
            xb = xb.clone()
            resid = zero
            for i in order:
                u, m_i = idx[i], mask[i]
                x_ext = xsum[u] - xb[i]
                xi = torch.where(m_i, fill_servers([i], x_ext[None])[0], zero)
                xi = (1.0 - alpha) * xb[i] + alpha * xi
                delta = torch.where(m_i, xi - xb[i], zero)
                xb[i] = torch.where(m_i, xi, zero)
                xsum.index_add_(0, u, delta)
                resid = torch.maximum(resid, delta.abs().amax())
            return xb, resid

    xb, *out = _outer(one_round, xb0, max_rounds, limit, alpha0, accel,
                      stall)
    cols = torch.arange(k, device=dev)[:, None].expand_as(idx)
    x = torch.zeros((n, k), dtype=dt, device=dev).index_put_(
        (idx, cols), torch.where(mask, xb, zero), accumulate=True)
    return (x, *out)


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
                      layout: str = "dense", buckets=None,
                      accel: str = "none", stall: bool = True,
                      device: DeviceLike = None):
    """Solve PS-DSF on ``device`` (default ``cuda``). Returns (x (N, K),
    rounds, residual) with x and the residual as tensors on that device,
    plus (accel_hits, accel_rejects) under ``accel="anderson"``.

    Inputs are tensors or numpy arrays: demands (N, R), capacities (K, R),
    weights (N,), gamma (N, K) (from :func:`gamma.gamma_matrix`), optional
    warm start ``x0`` (N, K) — a fixed point from the JAX reference
    included. Float64 demands solve in float64, anything else in float32.
    ``layout="bucketed"`` with ``buckets=(idx, mask)``, the padded arrays
    of a host-built ``layout.BucketedLayout``, runs the bucketed core;
    ``"auto"`` is resolved by ``engine.solve``, not here.
    ``placement="lexmm"`` is the identity on the level solve, as in the
    reference; ``placement="headroom"`` follows the level solve with up to
    three repack-and-refill passes
    (``placement_torch._repack_refill_core_torch``), dense whatever the
    level solve's layout, their refills plain (the Anderson counters are
    the level solve's); the other axes are validated by
    :func:`check_axes`. ``stall=False`` keeps the damping at its start
    (1 for Gauss-Seidel, 0.5 for Jacobi) instead of the stall schedule:
    the undamped Gauss-Seidel loop of the reference's gamma-direct solve
    (``extensions.solve_psdsf_gamma_tdm_torch``).
    """
    check_axes(mode=mode, placement=placement, fill=fill, round=round,
               layout=layout, accel=accel)
    _check_buckets(layout, buckets)
    dev = resolve_device(device)
    dt = _solve_dtype(demands)

    demands, capacities, weights, gamma = (
        to_device(a, dev, dt) for a in (demands, capacities, weights, gamma))
    n, k = gamma.shape
    x0 = torch.zeros((n, k), dtype=dt, device=dev) if x0 is None \
        else to_device(x0, dev, dt)
    kw = dict(fill=fill, round_mode=round, accel=accel, stall=stall)
    if layout == "bucketed":
        idx, mask = buckets
        out = _solve_core_bucketed_torch(
            demands, capacities, weights, gamma, x0, to_device(idx, dev),
            to_device(mask, dev), mode, max_rounds, tol, **kw)
    else:
        out = _solve_core_torch(demands, capacities, weights, gamma, x0,
                                mode, max_rounds, tol, **kw)
    if placement == "headroom":
        # placement_torch builds on this module's cores: imported here
        from .placement_torch import _repack_refill_core_torch
        out = _repack_refill_core_torch(
            demands, capacities, weights, gamma, *out[:3], mode, max_rounds,
            tol, fill=fill, round_mode=round) + tuple(out[3:])
    return out


def solve_psdsf_rdm_torch(problem: AllocationProblem, x0=None,
                          max_rounds: int = 64, fill: str = "event",
                          round: str = "gauss", accel: str = "none",
                          device: DeviceLike = None) -> Allocation:
    """PS-DSF under resource-division multiplexing on ``device`` (dense
    layout); returns the ``Allocation`` container (float64 host x)."""
    return _solve_problem(problem, "rdm", x0, max_rounds, fill, round, accel,
                          device)


def solve_psdsf_tdm_torch(problem: AllocationProblem, x0=None,
                          max_rounds: int = 64, fill: str = "event",
                          round: str = "gauss", accel: str = "none",
                          device: DeviceLike = None) -> Allocation:
    """PS-DSF under time-division multiplexing on ``device`` (dense
    layout)."""
    return _solve_problem(problem, "tdm", x0, max_rounds, fill, round, accel,
                          device)


def _solve_problem(problem, mode, x0, max_rounds, fill, round, accel,
                   device: Optional[DeviceLike]) -> Allocation:
    x = psdsf_solve_torch(
        problem.demands, problem.capacities, problem.weights,
        gamma_matrix(problem), x0=x0, mode=mode, max_rounds=max_rounds,
        fill=fill, round=round, accel=accel, device=device)[0]
    return Allocation(problem, x.double().cpu().numpy())
