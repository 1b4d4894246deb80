"""Sharing-property checkers (Section II-A, Theorems 1-3) on tensors: the
port of ``repro/core/properties.py``.

Each checker takes an ``Allocation`` and a tolerance, as the reference's
does, and returns ``(ok, detail)`` with the reference's detail text, from
the same first offender as the reference's loops: the lowest user, then
the user it envies; the ``argmin`` user for sharing incentive; the lowest
server, then user, for Theorems 1 and 2. The pair is a :class:`Verdict`,
which also carries that offender's indices (``where``) and the checked
quantity's worst value (``margin``).

Everything runs on ``device`` (``cuda`` unless the caller passes
``device="cpu"``) in float64, vectorised over users and servers where the
reference loops:

* :func:`check_envy_freeness_torch` forms the sums of ``x[m]`` over the
  servers eligible to ``n`` as one product ``S = E @ x^T`` (E the (N, K)
  eligibility ``gamma > 0``), a tile of ``ENVY_TILE`` users ``n`` at a
  time (the whole of S at 20,000 users is 3.2 GB), then
  ``u[n, m] = (phi_n/phi_m) * S[n, m] * min_{r: d[n,r] > 0} d[m,r]/d[n,r]``;
* :func:`check_bottleneck_structure_rdm_torch` keeps, per (server,
  resource), the two largest normalised VDS over the resource's holders,
  so "the holders other than n" costs O(1) a user;
* :func:`check_pareto_tdm_torch` takes each server's minimum normalised
  VDS from the ``psdsf_vds`` kernel (``kernels/psdsf_vds/ops.min_vds``,
  float32; its plain version for CPU tensors) and re-evaluates that
  minimum in float64 at the user it returns. A tie within float32
  rounding moves the minimum by ~1e-7 relative, below the check's 1e-6.

The TDM checkers (feasibility, sharing incentive, Pareto) need only gamma,
so they also certify Section IV's effective-capacity instances: an
``Allocation`` of an ``extensions.GammaProblem`` takes its gamma as given.

``ALLOCATOR_GUARANTEES_TORCH`` is the guarantee matrix of the reference's
property tests (``tests/test_properties.py::ALLOCATOR_GUARANTEES``) over
these checkers: the properties each registered mechanism guarantees.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..kernels.psdsf_vds.ops import min_vds
from .gamma import gamma_matrix_torch
from .types import Allocation, AllocationProblem

_RTOL = 1e-6
#: users ``n`` a tile of the envy check: a (tile, N) float64 block of S and
#: a few of its size, ~330 MB each at 20,000 users
ENVY_TILE = 2048


class Verdict(tuple):
    """``(ok, detail)``, as the reference's checkers return it, with the
    first offender's indices (``where``: empty when the check holds or its
    detail names none) and the worst value of the checked quantity
    (``margin``, in the units the check compares with its tolerance; each
    checker's docstring says which)."""

    def __new__(cls, ok: bool, detail: str, where: tuple = (),
                margin: float = float("nan")):
        self = super().__new__(cls, (bool(ok), detail))
        self.where = tuple(int(i) for i in where)
        self.margin = float(margin)
        return self

    @property
    def ok(self) -> bool:
        """Whether the property holds."""
        return self[0]

    @property
    def detail(self) -> str:
        """The reference's message: the first offender, or what holds."""
        return self[1]


def _arrays_torch(alloc: Allocation, device: DeviceLike):
    """x (N, K), demands (N, R), capacities (K, R), weights (N,) and gamma
    (N, K) of ``alloc`` as float64 tensors on ``device``. For an
    effective-capacity problem (``extensions.GammaProblem``: a ``gamma``
    and no demands) gamma is the problem's own, and demands and
    capacities are None."""
    dev = resolve_device(device)
    p = alloc.problem
    x, w = (to_device(a, dev, torch.float64) for a in (alloc.x, p.weights))
    if getattr(p, "gamma", None) is not None:
        return x, None, None, w, to_device(p.gamma, dev, torch.float64)
    d, c, e = (to_device(a, dev, torch.float64) for a in (
        p.demands, p.capacities, p.eligibility))
    return x, d, c, w, gamma_matrix_torch(d, c, e)


def _needs_demands(d, what: str) -> None:
    if d is None:
        raise ValueError(f"{what} needs demands: an effective-capacity "
                         f"problem (GammaProblem) has none")


def _cap_scale_torch(c):
    """The reference's per-entry capacity scale: max(cap, max(cap.max
    (initial=1) x 1e-6, 1e-12))."""
    top = max(float(c.max()), 1.0) if c.numel() else 1.0
    return torch.clamp(c, min=max(top * 1e-6, 1e-12))


def _first_index(mask) -> tuple:
    """Row-major index of the first True entry of ``mask``."""
    flat = int(torch.argmax(mask.reshape(-1).to(torch.int8)))
    return tuple(int(i) for i in np.unravel_index(flat, tuple(mask.shape)))


def check_feasible_rdm_torch(alloc: Allocation, tol: float = 1e-6, *,
                             device: DeviceLike = None) -> Verdict:
    """Eq. (9): sum_n x[n,i] d[n,r] <= c[i,r]; x >= 0; eligibility
    respected. ``margin``: max over (server, resource) of (usage - cap) /
    scale; ``where``: the first negative or ineligible (user, server), or
    the (server, resource) of the worst excess. On an effective-capacity
    problem (``GammaProblem``) there are no capacities to check: only the
    signs and the eligibility, and Eq. (10) (``check_feasible_tdm_torch``)
    carries the capacity condition."""
    x, d, c, _, g = _arrays_torch(alloc, device)
    neg = x < -tol
    if bool(neg.any()):
        return Verdict(False, "negative allocation", _first_index(neg))
    stray = (g <= 0) & (x > tol)
    if bool(stray.any()):
        return Verdict(False, "tasks on ineligible server",
                       _first_index(stray))
    if d is None:
        return Verdict(True, "feasible", margin=-math.inf)
    usage = x.T @ d
    scale = _cap_scale_torch(c)
    rel = (usage - c) / scale
    margin = float(rel.max()) if rel.numel() else -math.inf
    if bool((usage > c + tol * scale).any()):
        at = np.unravel_index(int(torch.argmax(rel)), tuple(rel.shape))
        return Verdict(False, f"capacity violated by rel {margin:.2e}", at,
                       margin)
    return Verdict(True, "feasible", margin=margin)


def check_feasible_tdm_torch(alloc: Allocation, tol: float = 1e-6, *,
                             device: DeviceLike = None) -> Verdict:
    """Eq. (10): sum_n x[n,i]/gamma[n,i] <= 1 per server (after Eq. 9,
    which TDM implies). ``margin``: the largest time share minus 1;
    ``where``: that server."""
    first = check_feasible_rdm_torch(alloc, tol, device=device)
    if not first.ok:
        return first
    x, _, _, _, g = _arrays_torch(alloc, device)
    share = torch.where(g > 0, x / g.clamp(min=1e-300), 0.0).sum(dim=0)
    top = float(share.max()) if share.numel() else -math.inf
    if bool((share > 1 + tol).any()):
        return Verdict(False, f"TDM time-share exceeded: max {top:.6f}",
                       (int(torch.argmax(share)),), top - 1.0)
    return Verdict(True, "feasible (TDM)", margin=top - 1.0)


def check_sharing_incentive_torch(alloc: Allocation, tol: float = 1e-6, *,
                                  device: DeviceLike = None) -> Verdict:
    """x_n >= sum_i (phi_n / sum_m phi_m) gamma[n,i] (generalized SI,
    §III-B). ``margin``: min over users of (got - uniform) / uniform;
    ``where``: its argmin user, the reference's offender."""
    x, _, _, w, g = _arrays_torch(alloc, device)
    share = w / w.sum()
    entitled = (g * share[:, None]).sum(dim=1)
    got = x.sum(dim=1)
    slack = got - entitled
    scale = entitled.clamp(min=1e-12)
    rel = slack / scale
    margin = float(rel.min()) if rel.numel() else math.inf
    if bool((slack < -tol * scale - 1e-9).any()):
        n = int(torch.argmin(rel))
        return Verdict(False, f"user {n}: got {float(got[n]):.6f} < uniform "
                              f"{float(entitled[n]):.6f}", (n,), margin)
    return Verdict(True, "sharing incentive holds", margin=margin)


def utility_of_torch(problem: AllocationProblem, n: int, a, *,
                     device: DeviceLike = None) -> float:
    """U_n(a) = min_{r: d[n,r] > 0} a_r / d[n,r] (Eq. 1)."""
    dev = resolve_device(device)
    d = to_device(problem.demands[n], dev, torch.float64)
    a = to_device(a, dev, torch.float64)
    mask = d > 0
    return float((a[mask] / d[mask]).min())


def check_envy_freeness_torch(alloc: Allocation, tol: float = 1e-6, *,
                              device: DeviceLike = None) -> Verdict:
    """Constrained envy freeness: U_n(phi_n/phi_m * a_m|eligible(n)) <=
    x_n, a_m|eligible(n) being m's tasks on the servers n is eligible for
    times m's demand vector (the scope of the paper's Theorem 3 proof; the
    classic definition without constraints). ``margin``: max over pairs
    (n, m), m != n, with m holding something on n's servers, of (u - x_n) /
    max(1, x_n); ``where``: (n, m), the lowest n, then the lowest m."""
    x, d, _, w, g = _arrays_torch(alloc, device)
    _needs_demands(d, "envy freeness")
    n_users, r_cnt = d.shape
    xn = x.sum(dim=1)
    elig = (g > 0).to(x.dtype)
    thresh = xn + tol * xn.clamp(min=1.0)
    margin = -math.inf
    found = None
    cols = torch.arange(n_users, device=x.device)
    for n0 in range(0, n_users, ENVY_TILE):
        n1 = min(n0 + ENVY_TILE, n_users)
        s = elig[n0:n1] @ x.T                       # (T, N): S[n, m]
        ratio = (w[n0:n1, None] / w[None, :])
        u = torch.full_like(s, math.inf)
        held = torch.full_like(s, -math.inf)
        for r in range(r_cnt):
            a_r = s * d[None, :, r]                 # a_m[r], m's tasks x d
            held = torch.maximum(held, a_r)
            dn = d[n0:n1, r, None]
            u = torch.where(dn > 0, torch.minimum(u, ratio * a_r / dn), u)
        counted = (held > 0) & (cols[None, :] != cols[n0:n1, None])
        rel = torch.where(counted, (u - xn[n0:n1, None])
                          / xn[n0:n1, None].clamp(min=1.0), -math.inf)
        if rel.numel():
            margin = max(margin, float(rel.max()))
        viol = counted & (u > thresh[n0:n1, None])
        if found is None and bool(viol.any()):
            t, m = _first_index(viol)
            found = (n0 + t, m, float(u[t, m]))
    if found is not None:
        n, m, u_nm = found
        return Verdict(False, f"user {n} envies {m}: {u_nm:.6f} > "
                              f"{float(xn[n]):.6f}", (n, m), margin)
    return Verdict(True, "envy free (constrained)", margin=margin)


def check_pareto_tdm_torch(alloc: Allocation, tol: float = 1e-6, *,
                           device: DeviceLike = None) -> Verdict:
    """Theorem 2 necessary condition: Eq. (10) tight on servers with
    eligible users, and every served user at the server's minimum
    normalized VDS x_n / (phi_n gamma[n,i]). The minimum comes from the
    ``psdsf_vds`` kernel and is re-evaluated in float64 at its argmin.
    ``margin``: the larger of max |share - 1| and max over served users of
    (s_norm - s_min) / max(1, s_min); ``where``: the lowest failing
    server."""
    x, _, _, w, g = _arrays_torch(alloc, device)
    if not x.shape[0]:
        return Verdict(True, "Pareto/TDM fixed-point condition holds",
                       margin=-math.inf)
    elig = g > 0
    has = elig.any(dim=0)
    xn = x.sum(dim=1)
    share = torch.where(elig, x / g.clamp(min=1e-300), 0.0).sum(dim=0)
    _, arg = min_vds(xn / w, g)
    arg = arg.long()
    k_idx = torch.arange(g.shape[1], device=g.device)
    s_min = torch.where(has, xn[arg] / (g[arg, k_idx] * w[arg]).clamp(
        min=1e-300), 0.0)
    s_norm = torch.where(elig, xn[:, None] / (g * w[:, None]).clamp(
        min=1e-300), -math.inf)
    served = elig & (x > tol)
    floor = s_min.clamp(min=1.0)
    excess = torch.where(served, (s_norm - s_min[None]) / floor[None],
                         -math.inf).amax(dim=0)
    excess = torch.where(has, excess, -math.inf)
    dev_share = torch.where(has, (share - 1.0).abs(), -math.inf)
    bad_share = has & ((share - 1.0).abs() > tol)
    bad_vds = has & (served & (s_norm > (s_min + tol * floor)[None])).any(0)
    margin = float(torch.maximum(dev_share, excess).max()) \
        if has.any() else -math.inf
    bad = bad_share | bad_vds
    if bool(bad.any()):
        i = int(torch.argmax(bad.to(torch.int8)))
        if bool(bad_share[i]):
            return Verdict(False, f"server {i}: time-share "
                                  f"{float(share[i]):.6f} != 1", (i,), margin)
        return Verdict(False, f"server {i}: served user above min VDS", (i,),
                       margin)
    return Verdict(True, "Pareto/TDM fixed-point condition holds",
                   margin=margin)


def check_bottleneck_structure_rdm_torch(alloc: Allocation, tol: float = 1e-5,
                                         *, device: DeviceLike = None
                                         ) -> Verdict:
    """Theorem 1: every user has a bottleneck resource w.r.t. every
    eligible server — r with d[n,r] > 0, saturated, and no holder of r
    (x[m,i] d[m,r] > tol, m != n) with higher normalized VDS than user n.
    Per (server, resource) the two largest holders' VDS stand for "the
    holders other than n". ``margin``: min over eligible (user, server) of
    the best resource's s_norm[n,i] (1 + 1e-6) + tol - max over the other
    holders (+inf with no other holder, -inf with no saturated demanded
    resource); ``where``: (user, server), the lowest server, then user."""
    x, d, c, w, g = _arrays_torch(alloc, device)
    _needs_demands(d, "the bottleneck structure")
    n_users, r_cnt = d.shape
    usage = x.T @ d
    sat = usage >= c - tol * _cap_scale_torch(c)                   # (K, R)
    elig = g > 0
    xn = x.sum(dim=1)
    s_norm = torch.where(elig, xn[:, None] / (g * w[:, None]).clamp(
        min=1e-300), math.inf)
    rows = torch.arange(n_users, device=x.device)[:, None]
    limit = s_norm * (1 + _RTOL) + tol
    best = torch.full_like(s_norm, -math.inf)
    for r in range(r_cnt):
        holds = x * d[:, r, None] > tol                            # (N, K)
        vals = torch.where(holds, s_norm, -math.inf)
        if n_users >= 2:
            top, at = torch.topk(vals, 2, dim=0)
            other = torch.where(rows == at[0][None], top[1][None],
                                top[0][None])
        else:
            other = torch.full_like(vals, -math.inf)
        cand = (d[:, r, None] > 0) & sat[None, :, r]
        best = torch.where(cand, torch.maximum(best, limit - other), best)
    fails = elig & ~(best >= 0)
    margin = float(torch.where(elig, best, math.inf).min()) \
        if elig.any() else math.inf
    if bool(fails.any()):
        i, n = _first_index(fails.T)
        return Verdict(False, f"user {n} has no bottleneck at server {i}",
                       (n, i), margin)
    return Verdict(True, "bottleneck structure holds (Theorem 1)",
                   margin=margin)


def weighted_max_min_check_torch(values, weights, reference,
                                 tol: float = 1e-4, *,
                                 device: DeviceLike = None) -> bool:
    """Sorted normalized vectors agree => same (weighted) max-min
    solution."""
    dev = resolve_device(device)
    v, w, ref = (to_device(a, dev, torch.float64)
                 for a in (values, weights, reference))
    a = torch.sort(v / w).values
    b = torch.sort(ref / w).values
    scale = b.abs().clamp(min=1.0)
    return bool(((a - b).abs() <= tol * scale).all())


#: the reference's guarantee matrix (``tests/test_properties.py::
#: ALLOCATOR_GUARANTEES``): the properties each mechanism guarantees
ALLOCATOR_GUARANTEES_TORCH = {
    "psdsf-rdm": (check_feasible_rdm_torch, check_sharing_incentive_torch,
                  check_envy_freeness_torch),
    "psdsf-tdm": (check_feasible_tdm_torch, check_sharing_incentive_torch,
                  check_envy_freeness_torch, check_pareto_tdm_torch),
    "drf": (check_feasible_rdm_torch, check_sharing_incentive_torch),
    "cdrfh": (check_feasible_rdm_torch,),
    "tsf": (check_feasible_rdm_torch,),
    "cdrf": (check_feasible_rdm_torch,),
    "uniform": (check_feasible_rdm_torch, check_sharing_incentive_torch),
}
