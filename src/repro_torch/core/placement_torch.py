"""Placement mirrors of the port: the stranded fraction and the
repack-and-refill of ``placement="headroom"`` on tensors (the port of
``repro/core/psdsf_jax.py``'s ``stranded_fraction_jnp``, ``_repack_core``
and ``_repack_refill_core``), and the host numpy repack the tick layer
runs after each tick (the port's own copy of ``repro/core/placement.py``'s
``headroom_matrix`` and ``repack_pass``).

A repack drains each user, largest total first, and re-splits its total
across its eligible servers in proportion to the headroom the drain freed
(``greedy``: best-fit first, host only). Totals are preserved exactly; the
split is feasible whenever the drained placement was. The refill after it
is the dense warm sweep ``psdsf_torch._solve_core_torch``, so with
``fill="bisect", round="jacobi"`` every refill round goes through the
Hopper ``psdsf_fill`` kernel on the card. The repack itself is the
reference's sequential loop over users: plain torch, outside any kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from .psdsf_torch import _BIG, _TOL, _solve_core_torch

#: repack-and-refill passes and the stranded-fraction drop a pass must
#: achieve to be kept (``placement.REPACK_PASSES`` / ``REPACK_MIN_GAIN``)
REPACK_PASSES = 3
REPACK_MIN_GAIN = 1e-6


def stranded_fraction_torch(demands, capacities, gamma, x):
    """Tensor twin of ``solveinfo.stranded_fraction``: the fraction of
    demandable capacity (cap > 0 and some eligible user demands the
    resource) that ``x`` leaves unused, as a 0-dim tensor."""
    dt = x.dtype
    wanted = (gamma > 0).to(dt).T @ (demands > 0).to(dt)
    mask = ((capacities > 0) & (wanted > 0)).to(dt)
    total = (capacities * mask).sum()
    used = (torch.einsum("nk,nr->kr", x, demands) * mask).sum()
    frac = 1.0 - torch.clamp(used / total.clamp(min=1e-300), max=1.0)
    return torch.where(total > 0, frac, torch.zeros_like(frac))


def _repack_core_torch(x, demands, capacities, weights, level_gamma, mode):
    """One drain-and-repack pass on tensors, proportional rule (port of
    ``psdsf_jax._repack_core``): users in a stable largest-total-first
    order, each drained and re-split across its eligible servers in
    proportion to the freed headroom (RDM: per-resource free capacity;
    TDM: per-server time-share slack). A user keeps its row when its total
    is 0 or the headroom cannot take it. The order is read back once; a
    user with total 0 changes nothing (its drain and refill add exact
    zeros), so the loop stops at the first one. Returns the new x."""
    del weights                     # the repack moves tasks; rates don't enter
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    eligible = level_gamma > 0
    if mode == "rdm":
        free = capacities - torch.einsum("nk,nr->kr", x, demands)
        du_safe = demands.clamp(min=1e-300)
        big = torch.full((), _BIG, dtype=x.dtype, device=x.device)
    else:
        inv_g = torch.where(eligible, 1.0 / level_gamma.clamp(min=1e-300),
                            zero)
        free = 1.0 - torch.einsum("nk,nk->k", x, inv_g)    # (K,) share slack
    totals = x.sum(dim=1)
    order = torch.argsort(-totals, stable=True)
    busy = int((totals > 0).sum())
    x = x.clone()
    for u in order[:busy].tolist():
        xu, du = x[u], demands[u]
        if mode == "rdm":
            free = free + xu[:, None] * du[None, :]                 # drain
            ratio = torch.where(du[None, :] > 0, free / du_safe[u][None, :],
                                big)
            h = torch.where(eligible[u], ratio.amin(dim=1), zero)
        else:
            free = free + xu * inv_g[u]
            h = torch.where(eligible[u], level_gamma[u] * free.clamp(min=0.0),
                            zero)
        h = h.clamp(min=0.0)
        t_u, hs = xu.sum(), h.sum()
        xnew = torch.where((t_u > 0) & (hs >= t_u),
                           t_u * h / hs.clamp(min=1e-300), xu)
        free = (free - xnew[:, None] * du[None, :] if mode == "rdm"
                else free - xnew * inv_g[u])
        x[u] = xnew
    return x


def _repack_refill_core_torch(demands, capacities, weights, gamma, x, rounds,
                              resid, mode, max_rounds, tol,
                              passes=REPACK_PASSES, min_gain=REPACK_MIN_GAIN,
                              loose_tol=5e-3, fill="event",
                              round_mode="gauss"):
    """Headroom placement for PS-DSF (port of
    ``psdsf_jax._repack_refill_core``): up to ``passes`` rounds of a
    repack followed by a warm dense re-sweep, each kept only when the
    refill's residual passes ``max(tol, loose_tol) x max(1, gamma.max())``
    and the stranded fraction drops by more than ``min_gain``. A pass that
    is not kept leaves the state as it was, so every later pass would
    repeat it exactly; the loop stops there. Returns the accepted
    (x, rounds, resid)."""
    scale = gamma.max().clamp(min=1.0)
    accept_limit = max(tol, loose_tol) * scale
    s_b = stranded_fraction_torch(demands, capacities, gamma, x)
    for _ in range(passes):
        xr = _repack_core_torch(x, demands, capacities, weights, gamma, mode)
        x2, r2, res2 = _solve_core_torch(
            demands, capacities, weights, gamma, xr, mode, max_rounds, tol,
            fill=fill, round_mode=round_mode)
        s2 = stranded_fraction_torch(demands, capacities, gamma, x2)
        if not bool((res2 <= accept_limit) & (s2 < s_b - min_gain)):
            break
        x, s_b, rounds, resid = x2, s2, r2, res2
    return x, rounds, resid


# ---------------------------------------------------------------------------
# host numpy repack of the tick layer (copy of repro/core/placement.py)
# ---------------------------------------------------------------------------

def headroom_matrix_np(demands: np.ndarray, free: np.ndarray,
                       eligible: np.ndarray) -> np.ndarray:
    """(N, K) tasks of user n that server i's free capacity could still
    take (min over the user's demanded resources), 0 where ineligible."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(demands[:, None, :] > 0,
                         free[None, :, :]
                         / np.maximum(demands, 1e-300)[:, None, :],
                         np.inf)
    return np.maximum(np.where(eligible, ratio.min(axis=2), 0.0), 0.0)


def repack_pass_np(demands: np.ndarray, capacities: np.ndarray,
                   x: np.ndarray, level_gamma: np.ndarray, mode: str = "rdm",
                   greedy: bool = False) -> np.ndarray:
    """One drain-and-repack pass on the host in float64, the reference's
    ``placement.repack_pass`` on a problem's demands (N, R) and capacities
    (K, R): users largest first, each re-split in proportion to the freed
    headroom, or with ``greedy`` best-fit first (a user that cannot be
    re-placed keeps its row). Totals are preserved exactly. Under TDM the
    headroom is the per-server time-share slack and ``level_gamma`` the
    gamma matrix itself."""
    d = demands
    x = x.copy()
    eligible = level_gamma > 0
    if mode == "rdm":
        free = capacities - np.einsum("nk,nr->kr", x, d)
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_g = np.where(eligible,
                             1.0 / np.maximum(level_gamma, 1e-300), 0.0)
        share_free = 1.0 - np.einsum("nk,nk->k", x, inv_g)
    for u in np.argsort(-x.sum(axis=1), kind="stable"):
        t_u = x[u].sum()
        if t_u <= 0:
            continue
        if mode == "rdm":
            free = free + np.outer(x[u], d[u])                    # drain
            h = headroom_matrix_np(d[u:u + 1], free, eligible[u:u + 1])[0]
        else:
            share_free = share_free + x[u] * inv_g[u]
            h = np.where(eligible[u],
                         level_gamma[u] * np.maximum(share_free, 0.0), 0.0)
        if greedy:
            xu = np.zeros_like(h)
            rem = t_u
            for i in np.argsort(-h, kind="stable"):
                take = min(rem, h[i])
                xu[i] = take
                rem -= take
                if rem <= _TOL * t_u:
                    break
            if rem > 1e-7 * t_u:
                xu = x[u]              # could not re-place: keep original
        else:
            hs = h.sum()
            xu = t_u * h / hs if hs >= t_u else x[u]
        x[u] = xu
        if mode == "rdm":
            free = free - np.outer(xu, d[u])
        else:
            share_free = share_free - xu * inv_g[u]
    return x
