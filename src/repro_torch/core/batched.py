"""Batched and incremental PS-DSF solves: the port of
``repro/core/psdsf_jax.py``'s ``psdsf_solve_batched``,
``psdsf_resolve_batched``, ``batch_problems`` and ``unbatch_solutions``.

The reference vmaps one solve over B problems; here the B problems go
through the port's sweep cores one after another (``_solve_core_torch`` /
``_solve_core_bucketed_torch``), so every problem keeps its own round
count, exactly as a converged problem's carry stops updating under the
reference's vmapped while_loop. With ``fill="bisect", round="jacobi"``
each round of each problem is one Hopper fill kernel call per saturation
event. ``placement="headroom"`` follows each problem's solve with its
repack-and-refill passes (``placement_torch._repack_refill_core_torch``,
dense). Padding from ``batch_problems`` is inert: padded users have weight
1 and gamma 0, padded servers and resources zero capacity, so they fill to
exact zeros.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from .gamma import gamma_matrix
from .placement_torch import _repack_refill_core_torch
from .psdsf_torch import (_check_buckets, _solve_core_bucketed_torch,
                          _solve_core_torch, _solve_dtype, check_axes)
from .types import Allocation, AllocationProblem


def _prepare(demands, capacities, weights, gamma, x0, layout, buckets,
             device):
    """The batch's arrays on ``device`` in the solve dtype (float64 demands
    solve in float64, anything else in float32), x0 zeros when None, and
    the (B, K, Bmax) buckets when bucketed."""
    dev = resolve_device(device)
    dt = _solve_dtype(demands)
    demands, capacities, weights, gamma = (
        to_device(a, dev, dt) for a in (demands, capacities, weights, gamma))
    x0 = torch.zeros_like(gamma) if x0 is None else to_device(x0, dev, dt)
    if layout == "bucketed":
        idx, mask = buckets
        buckets = (to_device(idx, dev).long(),
                   to_device(mask, dev, torch.bool))
    return demands, capacities, weights, gamma, x0, buckets


def _stack(rows):
    """Per-problem result rows (x, then scalars: ints or 0-dim tensors) ->
    one tensor a column, stacked over the batch: (x (B, N, K), (B,)...)."""
    dev = rows[0][0].device
    return tuple(torch.stack([torch.as_tensor(r[c], device=dev)
                              for r in rows]) for c in range(len(rows[0])))


def psdsf_solve_batched(demands, capacities, weights, gamma, *, x0=None,
                        mode: str = "rdm", max_rounds: int = 256,
                        tol: float = 1e-6, placement: str = "level",
                        fill: str = "event", round: str = "gauss",
                        layout: str = "dense", buckets=None,
                        accel: str = "none", device: DeviceLike = None):
    """Solve B independent PS-DSF problems on ``device`` (default ``cuda``).

    Shapes: demands (B, N, R), capacities (B, K, R), weights (B, N), gamma
    (B, N, K), optional warm start x0 (B, N, K); tensors or numpy arrays
    (e.g. from :func:`batch_problems`). Returns (x (B, N, K), rounds (B,),
    residual (B,)) as tensors on ``device``, plus per-problem
    (accel_hits, accel_rejects) under ``accel="anderson"``; each problem's
    round count is its own. ``layout="bucketed"`` takes per-problem
    ``buckets`` = (idx, mask) stacks of shape (B, K, Bmax), each problem's
    ``layout.BucketedLayout`` padded to a common Bmax with masked slots.
    ``mode``/``placement``/``fill``/``round``/``accel`` as in
    ``psdsf_torch.psdsf_solve_torch``.
    """
    check_axes(mode=mode, placement=placement, fill=fill, round=round,
               layout=layout, accel=accel)
    _check_buckets(layout, buckets)
    d, c, w, g, x0, bkt = _prepare(demands, capacities, weights, gamma, x0,
                                   layout, buckets, device)
    kw = dict(fill=fill, round_mode=round, accel=accel)
    outs = []
    for j in range(g.shape[0]):
        if layout == "bucketed":
            out = _solve_core_bucketed_torch(
                d[j], c[j], w[j], g[j], x0[j], bkt[0][j], bkt[1][j], mode,
                max_rounds, tol, **kw)
        else:
            out = _solve_core_torch(d[j], c[j], w[j], g[j], x0[j], mode,
                                    max_rounds, tol, **kw)
        if placement == "headroom":
            out = _repack_refill_core_torch(
                d[j], c[j], w[j], g[j], *out[:3], mode, max_rounds, tol,
                fill=fill, round_mode=round) + tuple(out[3:])
        outs.append(out)
    return _stack(outs)


def psdsf_resolve_batched(demands, capacities, weights, gamma, x0, servers, *,
                          mode: str = "rdm", max_rounds: int = 64,
                          tol: float = 1e-4, placement: str = "level",
                          fill: str = "event", round: str = "gauss",
                          layout: str = "dense", buckets=None,
                          accel: str = "none", device: DeviceLike = None):
    """Event-driven incremental re-solve of B perturbed problems on
    ``device`` (default ``cuda``).

    ``servers`` (B, S) lists the servers each scenario's events touch
    (degraded servers and every server an arriving or departing user is
    eligible on; pad a row by repeating any listed index: refilling an
    unaffected server is idempotent). Phase 1 sweeps only those servers
    from the warm start ``x0`` (B, N, K) at alpha0 = 0.3; phase 2 runs full
    sweeps from there, pre-damped at alpha0 = 0.02, until the GLOBAL
    residual passes ``tol``, so a ripple that escapes the restricted set is
    caught. Both phases run on the chosen layout, fill and round.

    Returns (x, rounds_restricted, rounds_full, residual) as tensors, the
    residual the full sweeps'; ``accel="anderson"`` runs the mixer in both
    phases and appends their summed (accel_hits, accel_rejects).
    ``placement="headroom"`` appends the repack-and-refill passes after the
    verification sweeps (full sweeps: the repack is global); a kept pass
    replaces ``rounds_full`` and the residual. The other arguments are
    :func:`psdsf_solve_batched`'s.
    """
    check_axes(mode=mode, placement=placement, fill=fill, round=round,
               layout=layout, accel=accel)
    _check_buckets(layout, buckets)
    d, c, w, g, x0, bkt = _prepare(demands, capacities, weights, gamma, x0,
                                   layout, buckets, device)
    srv = to_device(servers, d.device).long()
    kw = dict(fill=fill, round_mode=round, accel=accel)
    rows = []
    for j in range(g.shape[0]):
        def core(x_init, servers=None, alpha0=1.0):
            if layout == "bucketed":
                return _solve_core_bucketed_torch(
                    d[j], c[j], w[j], g[j], x_init, bkt[0][j], bkt[1][j],
                    mode, max_rounds, tol, servers=servers, alpha0=alpha0,
                    **kw)
            return _solve_core_torch(d[j], c[j], w[j], g[j], x_init, mode,
                                     max_rounds, tol, servers=servers,
                                     alpha0=alpha0, **kw)

        # the warm start is near the fixed point: alpha0 = 0.3 absorbs a
        # cell-local perturbation without re-exciting the restricted
        # subproblem's limit cycle; the verification starts pre-damped at
        # about the level where a cold solve's own schedule accepts
        out1 = core(x0[j], servers=srv[j], alpha0=0.3)
        out2 = core(out1[0], alpha0=0.02)
        x, r_full, resid = out2[:3]
        if placement == "headroom":
            x, r_full, resid = _repack_refill_core_torch(
                d[j], c[j], w[j], g[j], x, r_full, resid, mode, max_rounds,
                tol, fill=fill, round_mode=round)
        row = [x, out1[1], r_full, resid]
        if accel == "anderson":
            row += [out1[3] + out2[3], out1[4] + out2[4]]
        rows.append(row)
    return _stack(rows)


def batch_problems(problems: Sequence[AllocationProblem], dtype=np.float32,
                   device: DeviceLike = None) -> dict:
    """Zero-pad a sequence of ``AllocationProblem`` to a common (N, K, R)
    and stack them for :func:`psdsf_solve_batched`, as tensors of
    ``dtype`` on ``device`` (default ``cuda``).

    Returns a dict with demands (B, N, R), capacities (B, K, R), weights
    (B, N), gamma (B, N, K) and sizes [(n_i, k_i)]. Padded users get weight
    1 and gamma 0 (never allocated); padded servers and resources get zero
    capacity.
    """
    dev = resolve_device(device)
    n_max = max(p.num_users for p in problems)
    k_max = max(p.num_servers for p in problems)
    r_max = max(p.num_resources for p in problems)
    b = len(problems)
    demands = np.zeros((b, n_max, r_max), dtype)
    capacities = np.zeros((b, k_max, r_max), dtype)
    weights = np.ones((b, n_max), dtype)
    gamma = np.zeros((b, n_max, k_max), dtype)
    sizes = []
    for j, p in enumerate(problems):
        n, k, r = p.num_users, p.num_servers, p.num_resources
        demands[j, :n, :r] = p.demands
        capacities[j, :k, :r] = p.capacities
        weights[j, :n] = p.weights
        gamma[j, :n, :k] = gamma_matrix(p)
        sizes.append((n, k))
    out = {name: to_device(a, dev) for name, a in (
        ("demands", demands), ("capacities", capacities),
        ("weights", weights), ("gamma", gamma))}
    out["sizes"] = sizes
    return out


def unbatch_solutions(x, problems: Sequence[AllocationProblem]
                      ) -> List[Allocation]:
    """Slice a padded (B, N, K) solution (tensor or array) back into
    per-problem Allocations (float64 host arrays)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float64).cpu().numpy()
    return [Allocation(p, np.asarray(x[j, :p.num_users, :p.num_servers],
                                     dtype=np.float64))
            for j, p in enumerate(problems)]
