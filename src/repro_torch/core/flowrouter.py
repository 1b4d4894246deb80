"""Exact lexicographic max-min flow router (``placement="lexmm"``): the
port's own copy of ``repro/core/flowrouter.py``.

The router is host numpy/scipy code in the reference as here: its level
increments are certified by LP solves, which have no device mirror. So
this module is a copy, not a rewrite: the same LPs in the same order, so
that on one machine both packages return the same x. Classes keep their
names; module-level functions carry an ``_np`` suffix (``lexmm_route_np``,
``lexmm_route_cold_np``, ``_level_rates_np``, ``_solve_lp_np``,
``_highs_np``), so no function of the port shares a base name with one of
the reference (the reference's contract lint grounds calls by base name).

The routed heuristics (``headroom``) pack tightly but certify feasibility
only: splitting a user's fill rate by per-server headroom can consume
capacity a constrained user has no alternative to, losing the max-min
level on small adversarial instances. This module closes that gap with the
standard water-filling-via-flow construction, solved exactly:

1. raise every active user's level together and certify the largest common
   increment by solving the routing feasibility problem on the tripartite
   network  *source -> users -> eligible-server arcs -> per-(server,
   resource) capacity rows*;
2. freeze the users that are lexicographically *blocked* at the certified
   level (cannot exceed it while everyone else keeps at least it — the
   water-filling saturation condition);
3. repeat with the remaining users until everyone is frozen.

Each certificate is a max-flow feasibility problem whose arcs carry
multi-resource consumption: one task of user n routed to server i draws
``d[n, r]`` on every capacity row (i, r) of that server. With one resource
per server this IS plain max-flow; with several it is the natural
generalized-flow linear program, solved with scipy's HiGHS (an exact
simplex/IPM: vertex solutions are accurate to fp round-off). If scipy is
absent, ``lexmm`` raises ``FlowRouterUnavailable`` at solve time and every
other placement keeps working.

Correctness sketch (the classic progressive-filling argument): the
feasible set of user totals is a polytope, so at the maximal common
increment the blocked set is non-empty, each stage freezes at least one
user, and freezing exactly the blocked users yields the lexicographically
maximal sorted level vector. Blocked users are found without per-user LPs:
maximize the *sum* of per-candidate slacks; a zero optimum proves every
candidate individually blocked, while candidates with positive slack are
provably raisable and leave the candidate set — at least one candidate
resolves per iteration.

Warm start (``RouterState``)
----------------------------

``RouterState`` keeps three things alive between solves:

* the certificate *matrices* (incidence + cached increment column), built
  once per (topology, rate) pair and reused with rhs/objective swaps;
* the increment LP's equality-row *duals*, which seed the freeze-candidate
  set (only dual-tight users need the sum-of-slacks certificate);
* the solved stage *trace* (level + freeze batch per stage), which turns a
  re-solve into a verification pass: one capped-slack certificate LP per
  stage, at the traced level, whose zero optimum proves the traced levels
  feasible, blocked and maximal. The warm path never trusts cached state
  it has not re-proven against the current rhs.

Churn deltas compose with the trace: a *departure* only relaxes the
network, so verification walks the trace with the departed rows pinned to
zero and re-solves only from the first stage that fails. An *arrival*
tightens the network at level zero, which invalidates every traced level,
so the router falls back to a full (still matrix-warm) solve and says so
via ``RouterStats.warm_fallbacks``.

When scipy's private HiGHS wrapper is importable the LPs run through it
directly (dual simplex + devex for increments, primal simplex for
certificates); otherwise every LP falls back to the public
``scipy.optimize.linprog`` with identical semantics (equality-row
marginals still seed the candidates). Which path ran shows as
``RouterStats.backend`` ("direct" or "linprog").

Scope: the router needs a *server-independent* level rate (a user's level
must not depend on where its tasks land), i.e. the global-share mechanisms
cdrfh/tsf/cdrf, whose level-rate matrix is ``w_n`` on eligible servers
(``baselines_torch.level_rate_matrix_np``). PS-DSF's per-server water
levels have no routing freedom, so ``placement="lexmm"`` is the identity on
its level fill.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .trace import Tracer
from .types import AllocationProblem

#: relative tolerance deciding whether a candidate's slack proves it
#: raisable; relative to the certified common level, so uniformly rescaled
#: instances classify identically
_BLOCK_RTOL = 1e-7

#: relative spread allowed in a user's per-arc level rates before the
#: router refuses (routing freedom presumes the rate is server-independent)
_RATE_RTOL = 1e-9

#: absolute threshold on an increment LP's equality-row marginal below
#: which the user is provably not binding the last increment (and so needs
#: no blockedness certificate this stage)
_DUAL_SEED_ATOL = 1e-9

#: slack cap in the certificate LP, as a fraction of the certified level —
#: capping keeps the columns bounded without weakening the zero-optimum
#: proof (caps only matter when the optimum is already positive)
_SLACK_CAP_FRAC = 0.1


class FlowRouterUnavailable(ImportError):
    """scipy (the LP back end of the level-increment certificates) missing."""


def _highs_np():
    try:
        from scipy import sparse
        from scipy.optimize import linprog
    except ImportError as exc:                      # pragma: no cover
        raise FlowRouterUnavailable(
            "placement='lexmm' certifies its level increments with scipy's "
            "HiGHS LP solver; install scipy or pick another placement "
            "strategy (level/headroom)") from exc
    return linprog, sparse


class _DirectHighs:
    """Handle on scipy's private ``_highs_wrapper`` (fast path; optional).

    The wrapper takes the constraint matrix as raw CSC triplets with ranged
    rows (lhs <= Ax <= rhs), so capacity rows (lhs = -inf) and user-total
    equalities (lhs = rhs) stack into ONE matrix that is cached across
    calls. Everything here is private scipy API, so construction is gated
    behind ``try_import`` and the router degrades to the public ``linprog``
    when any piece is missing or renamed.
    """

    BIG = 1e20       # the wrapper's stand-in for +/- infinity
    OPTIMAL = 7      # HighsModelStatus::kOptimal

    def __init__(self, wrapper, opts_inc, opts_cert):
        self.wrapper = wrapper
        self.opts_inc = opts_inc
        self.opts_cert = opts_cert
        self.int0 = np.empty(0, dtype=np.uint8)   # "no integrality" marker

    @classmethod
    def try_import(cls) -> Optional["_DirectHighs"]:
        """Build the fast path, or None if the private API is unavailable."""
        try:
            from scipy.optimize._highs._highs_constants import (
                HIGHS_OBJECTIVE_SENSE_MINIMIZE,
                HIGHS_SIMPLEX_CRASH_STRATEGY_OFF,
                HIGHS_SIMPLEX_EDGE_WEIGHT_STRATEGY_DEVEX,
                HIGHS_SIMPLEX_STRATEGY_DUAL,
                HIGHS_SIMPLEX_STRATEGY_PRIMAL,
                MESSAGE_LEVEL_NONE,
            )
            from scipy.optimize._highs._highs_wrapper import _highs_wrapper
        except ImportError:                         # pragma: no cover
            return None

        def opts(strategy):
            # presolve off: these LPs are presolve-irreducible (measured),
            # so presolve only adds overhead; devex pricing measured
            # fastest on the pinned instances for both strategies
            return {
                "presolve": False,
                "sense": HIGHS_OBJECTIVE_SENSE_MINIMIZE,
                "solver": "simplex",
                "highs_debug_level": MESSAGE_LEVEL_NONE,
                "log_to_console": False,
                "output_flag": False,
                "simplex_strategy": strategy,
                "simplex_crash_strategy": HIGHS_SIMPLEX_CRASH_STRATEGY_OFF,
                "simplex_dual_edge_weight_strategy":
                    HIGHS_SIMPLEX_EDGE_WEIGHT_STRATEGY_DEVEX,
            }

        return cls(_highs_wrapper,
                   opts(HIGHS_SIMPLEX_STRATEGY_DUAL),
                   opts(HIGHS_SIMPLEX_STRATEGY_PRIMAL))


class RoutingNetwork:
    """The fixed-topology certificate network for one (problem, rate) pair.

    Arcs are the eligible (user, server) pairs; capacity rows are the
    (server, resource) pairs some arc draws on. Built once per solve — every
    stage's LP reuses the same incidence matrices and only changes
    right-hand sides / objective columns.
    """

    def __init__(self, problem: AllocationProblem, eligible: np.ndarray,
                 users: np.ndarray):
        _, sparse = _highs_np()
        d = problem.demands
        cap = problem.capacities
        self.users = users                            # in-scope user ids
        arc_user, arc_server = np.nonzero(eligible)
        self.arc_user = arc_user
        self.arc_server = arc_server
        p = arc_user.shape[0]
        # normalize capacities so HiGHS' absolute feasibility tolerances are
        # relative to THIS instance's magnitudes (uniform rescale invariance)
        self.cap_scale = float(cap.max(initial=0.0)) or 1.0
        # capacity rows: only (i, r) pairs some arc draws on
        draws = np.zeros_like(cap, dtype=bool)
        np.logical_or.at(draws, arc_server, d[arc_user] > 0)
        row_server, row_res = np.nonzero(draws)
        self.row_server = row_server                  # per-cap-row server id
        self.row_res = row_res                        # per-cap-row resource id
        row_of = np.full(cap.shape, -1, dtype=np.int64)
        row_of[row_server, row_res] = np.arange(row_server.shape[0])
        # COO triplets: arc p draws d[arc_user[p], r] on row (arc_server[p], r)
        coefs = d[arc_user]                           # (P, R)
        pr_arc, pr_res = np.nonzero(coefs)
        rows = row_of[arc_server[pr_arc], pr_res]
        self.a_cap = sparse.csr_matrix(
            (coefs[pr_arc, pr_res], (rows, pr_arc)),
            shape=(row_server.shape[0], p))
        self.b_cap = cap[row_server, row_res] / self.cap_scale
        # user-total incidence (one row per in-scope user, ones on its arcs)
        urow = np.searchsorted(users, arc_user)
        self.a_user = sparse.csr_matrix(
            (np.ones(p), (urow, np.arange(p))), shape=(users.shape[0], p))

    @property
    def num_arcs(self) -> int:
        """Number of eligible (user, server) arcs."""
        return self.arc_user.shape[0]

    def scatter(self, x_arc: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
        """Scatter arc flows back to a dense (N, K) task matrix."""
        x = np.zeros(shape)
        x[self.arc_user, self.arc_server] = x_arc * self.cap_scale
        return x


@dataclass
class RouterStats:
    """Observability record for one ``RouterState`` solve/resolve.

    ``mode`` says which path produced the allocation: ``"warm"`` (full
    matrix-warm solve), ``"verify"`` (every traced stage re-certified),
    ``"incremental"`` (prefix verified, suffix re-solved after a
    departure) or ``"fallback"`` (cached trace invalidated — arrival or
    re-parameterization — so a full solve ran; ``warm_fallbacks`` counts
    these loudly). ``warm_hits`` counts traced stages reused via a
    zero-optimum verification certificate. ``stage_ms`` has one wall-time
    entry per certified stage, in stage order.
    """

    stages: int = 0
    lp_calls: int = 0
    lp_iters: int = 0
    warm_hits: int = 0
    warm_fallbacks: int = 0
    solve_ms: float = 0.0
    stage_ms: tuple = ()
    mode: str = "warm"
    backend: str = "direct"


@dataclass
class _Stage:
    """One solved water-filling stage: its level and who froze there."""

    level: float                 # certified common level (scaled units)
    frozen: np.ndarray           # positions (into RouterState.users) frozen


@dataclass
class _SolveState:
    """Mutable stage-loop state shared by full solves and suffix re-solves."""

    t_eq: np.ndarray             # frozen totals (scaled), 0 for inactive
    active: np.ndarray           # bool mask over router.users positions
    level: float
    x_arc: np.ndarray
    trace: List[_Stage] = field(default_factory=list)


class RouterState:
    """Persistent warm-started lexmm router (see the module docstring).

    Construction validates the rate matrix and builds the certificate
    matrices once; ``solve`` runs the full dual-seeded stage loop,
    ``resolve`` reuses the cached stage trace (verify / incremental /
    flagged fallback — it picks the cheapest sound path for the activity
    delta), and ``update`` re-parameterizes rates or capacities in place.
    Every path returns ``(x, RouterStats)`` with allocations identical to
    the one-shot ``lexmm_route_cold_np`` up to LP round-off (~1e-12 on the
    pinned instances; the CI gate asserts 1e-6).
    """

    def __init__(self, problem: AllocationProblem, level_gamma: np.ndarray):
        linprog, sparse = _highs_np()
        self._linprog = linprog
        self._sparse = sparse
        self.problem = problem
        self.shape = level_gamma.shape
        rate = _level_rates_np(problem, level_gamma)
        self.users = np.nonzero(rate > 0)[0]
        self.support = level_gamma > 0
        if self.users.size == 0:
            self.net = None
            self._trace: Optional[List[_Stage]] = None
            self._invalidated = False
            self.last_stats: Optional[RouterStats] = None
            return
        self.net = RoutingNetwork(problem, self.support, self.users)
        self.r = rate[self.users] / rate[self.users].max()
        self.nu = self.users.shape[0]
        self.p = self.net.num_arcs
        self.ncap = self.net.b_cap.shape[0]
        # one ranged-row matrix [capacity rows; user-total rows], cached in
        # CSC for the direct wrapper; certificate calls hstack slack columns
        # onto it, the increment call reuses a cached delta column in place
        self.base = sparse.vstack([self.net.a_cap, self.net.a_user],
                                  format="csc")
        dcol = sparse.csc_matrix(
            (-self.r, (self.ncap + np.arange(self.nu), np.zeros(self.nu, int))),
            shape=(self.ncap + self.nu, 1))
        self.a_inc = sparse.hstack([self.base, dcol], format="csc")
        self._dcol = slice(self.a_inc.indptr[self.p],
                           self.a_inc.indptr[self.p + 1])
        self.rhs_cap = self.net.b_cap.copy()
        self._cap_vec = np.ones(problem.num_servers)
        self._direct = _DirectHighs.try_import()
        self.last_stats: Optional[RouterStats] = None
        # persistent solution state (None until the first solve)
        self._trace = None
        self._act_mask: Optional[np.ndarray] = None
        self._t_eq: Optional[np.ndarray] = None
        self._x_arc: Optional[np.ndarray] = None
        self._invalidated = False

    # -- low-level LP calls --------------------------------------------------

    def _lp_direct(self, a, c, b_eq, ub, opts):
        """One LP through the private wrapper on the ranged-row matrix."""
        d = self._direct
        lhs = np.concatenate([np.full(self.ncap, -d.BIG), b_eq])
        rhs = np.concatenate([self.rhs_cap, b_eq])
        res = d.wrapper(c, a.indptr, a.indices, a.data, lhs, rhs,
                        np.zeros(c.shape[0]), ub, d.int0, opts)
        if res.get("status") != d.OPTIMAL:
            raise RuntimeError(
                f"lexmm certificate LP failed (status {res.get('status')}): "
                f"{res.get('message')}")
        return (np.asarray(res["x"]),
                np.asarray(res["lambda"])[self.ncap:],
                int(res.get("simplex_nit") or 0))

    def _lp_public(self, rows, cols, vals, m, c_extra, ub_extra, b_eq):
        """Public ``linprog`` fallback with split ub/eq matrices."""
        sparse = self._sparse
        eq_cols = sparse.csr_matrix((vals, (rows, cols)), shape=(self.nu, m))
        a_eq = sparse.hstack([self.net.a_user, eq_cols], format="csr")
        a_ub = sparse.hstack(
            [self.net.a_cap, sparse.csr_matrix((self.ncap, m))], format="csr")
        c = np.zeros(self.p + m)
        c[self.p:] = c_extra
        bounds = [(0, None)] * self.p + [(0, u) for u in ub_extra]
        res = self._linprog(c, A_ub=a_ub, b_ub=self.rhs_cap, A_eq=a_eq,
                            b_eq=b_eq, bounds=bounds, method="highs")
        if res.status != 0:
            raise RuntimeError(
                f"lexmm certificate LP failed (status {res.status}): "
                f"{res.message}")
        return (np.asarray(res.x), np.asarray(res.eqlin.marginals),
                int(res.nit))

    def _increment_lp(self, active, b_eq, stats):
        """Max common-level increment over ``active``; returns duals too."""
        if self._direct is not None:
            self.a_inc.data[self._dcol] = np.where(active, -self.r, 0.0)
            c = np.zeros(self.p + 1)
            c[-1] = -1.0
            ub = np.full(self.p + 1, self._direct.BIG)
            x, duals, nit = self._lp_direct(self.a_inc, c, b_eq, ub,
                                            self._direct.opts_inc)
        else:
            act = np.nonzero(active)[0]
            x, duals, nit = self._lp_public(
                act, np.zeros(act.shape[0], int), -self.r[act], 1,
                np.array([-1.0]), [None], b_eq)
        stats.lp_calls += 1
        stats.lp_iters += nit
        return x[:self.p], float(x[self.p]), duals

    def _certificate_lp(self, cand, b_eq, level, stats):
        """Sum-of-capped-slacks certificate over ``cand`` at ``level``."""
        m = cand.shape[0]
        capv = _SLACK_CAP_FRAC * max(level, 1.0)
        if self._direct is not None:
            scol = self._sparse.csc_matrix(
                (-self.r[cand], (self.ncap + cand, np.arange(m))),
                shape=(self.ncap + self.nu, m))
            a = self._sparse.hstack([self.base, scol], format="csc")
            c = np.zeros(self.p + m)
            c[self.p:] = -1.0
            ub = np.full(self.p + m, self._direct.BIG)
            ub[self.p:] = capv
            x, _, nit = self._lp_direct(a, c, b_eq, ub,
                                        self._direct.opts_cert)
        else:
            x, _, nit = self._lp_public(
                cand, np.arange(m), -self.r[cand], m,
                np.full(m, -1.0), np.full(m, capv), b_eq)
        stats.lp_calls += 1
        stats.lp_iters += nit
        return x[:self.p], x[self.p:]

    # -- stage machinery -----------------------------------------------------

    def _freeze(self, cand, b_eq, level, stats):
        """Shrink ``cand`` to the provably blocked set (empty if none)."""
        x_arc = None
        while cand.size:
            x, eps = self._certificate_lp(cand, b_eq, level, stats)
            raisable = eps > _BLOCK_RTOL * max(level, 1e-300)
            if not raisable.any():
                return cand, x
            cand = cand[~raisable]
        return cand, x_arc

    def _run_stages(self, st: _SolveState, stats: RouterStats,
                    tracer: Tracer) -> None:
        """Run the water-filling loop from ``st`` until everyone froze."""
        while st.active.any():
            stats.stages += 1
            if stats.stages > self.nu + 1:            # theory: <= |users|
                raise RuntimeError(
                    "lexmm did not converge in |users| stages")
            with tracer.span(f"stage{stats.stages}"):
                act_idx = np.nonzero(st.active)[0]
                b_eq = np.where(st.active, self.r * st.level, st.t_eq)
                x_arc, delta, duals = self._increment_lp(
                    st.active, b_eq, stats)
                st.level += delta
                st.x_arc = x_arc   # feasible at the raised level by the
                                   # increment LP's own equality rows
                b_eq = np.where(st.active, self.r * st.level, st.t_eq)
                # dual seeding: only users binding the increment can be
                # blocked; a zero marginal proves slack in the last
                # direction of improvement
                cand = act_idx[np.abs(duals[act_idx]) > _DUAL_SEED_ATOL]
                seeded = 0 < cand.size < act_idx.size
                if cand.size == 0:
                    cand = act_idx.copy()
                blocked, x_cert = self._freeze(cand, b_eq, st.level, stats)
                if blocked.size == 0 and seeded:
                    # the seed was a strict subset and everyone in it proved
                    # raisable — rerun with the full candidate set so the
                    # stage still freezes the true blocked batch
                    blocked, x_cert = self._freeze(act_idx.copy(), b_eq,
                                                   st.level, stats)
                if blocked.size == 0:
                    # cannot happen for a polytope (module docstring);
                    # freeze everyone rather than loop forever on fp noise
                    blocked = act_idx
                if x_cert is not None:
                    st.x_arc = x_cert
                st.t_eq[blocked] = self.r[blocked] * st.level
                st.active[blocked] = False
                st.trace.append(_Stage(st.level, blocked))

    def _mask(self, active) -> np.ndarray:
        """Full-problem activity mask -> mask over router user positions."""
        if active is None:
            return np.ones(self.nu, dtype=bool)
        return np.asarray(active, dtype=bool)[self.users]

    def _store(self, st: _SolveState, act_mask: np.ndarray,
               stats: RouterStats, tracer: Tracer, t0: float) -> np.ndarray:
        """Persist solved state and finalize stats; returns the dense x."""
        self._trace = st.trace
        self._act_mask = act_mask
        self._t_eq = st.t_eq
        self._x_arc = st.x_arc
        self._invalidated = False
        stats.stage_ms = tracer.stage_ms()
        stats.solve_ms = (time.perf_counter() - t0) * 1e3
        stats.backend = "direct" if self._direct is not None else "linprog"
        self.last_stats = stats
        return self.net.scatter(st.x_arc, self.shape)

    # -- public API ----------------------------------------------------------

    def solve(self, active=None) -> Tuple[np.ndarray, RouterStats]:
        """Full (matrix-warm, dual-seeded) solve; rebuilds the stage trace.

        ``active`` is an optional boolean mask over ALL problem users;
        inactive users are pinned to zero tasks (their equality rows stay
        in the LP with rhs 0, so no matrix rebuild).
        """
        t0 = time.perf_counter()
        stats = RouterStats(mode="warm")
        if self.net is None:
            stats.backend = "none"
            self.last_stats = stats
            return np.zeros(self.shape), stats
        act_mask = self._mask(active)
        tracer = Tracer()
        st = _SolveState(t_eq=np.zeros(self.nu), active=act_mask.copy(),
                         level=0.0, x_arc=np.zeros(self.p))
        self._run_stages(st, stats, tracer)
        return self._store(st, act_mask, stats, tracer, t0), stats

    def resolve(self, active=None) -> Tuple[np.ndarray, RouterStats]:
        """Re-solve against the cached trace (verify / incremental path).

        Walks the traced stages re-certifying each with one LP (see the
        module docstring for why a zero optimum is a full proof). On an
        unchanged activity mask every stage verifies (``mode="verify"``);
        after departures the prefix before the first affected freeze batch
        verifies and only the suffix re-solves (``mode="incremental"``);
        arrivals or a prior ``update`` invalidate the trace and trigger a
        full solve with ``warm_fallbacks`` set (``mode="fallback"``).
        """
        if self.net is None or self._trace is None:
            invalidated = self._invalidated
            x, stats = self.solve(active)
            if invalidated:
                stats.mode = "fallback"
                stats.warm_fallbacks += 1
            return x, stats
        act_mask = self._mask(active)
        arrived = act_mask & ~self._act_mask
        if arrived.any():
            x, stats = self.solve(active)
            stats.mode = "fallback"
            stats.warm_fallbacks += 1
            return x, stats
        t0 = time.perf_counter()
        stats = RouterStats(
            mode="verify" if (act_mask == self._act_mask).all()
            else "incremental")
        tracer = Tracer()
        st = _SolveState(t_eq=np.zeros(self.nu),
                         active=np.zeros(self.nu, dtype=bool),
                         level=0.0, x_arc=np.zeros(self.p))
        frozen_before = np.zeros(self.nu, dtype=bool)
        verified = 0
        for stage in self._trace:
            keep = stage.frozen[act_mask[stage.frozen]]
            if keep.size == 0:
                break     # the whole batch departed: maximality unprovable
            b_eq = np.where(
                act_mask,
                np.where(frozen_before, st.t_eq, self.r * stage.level), 0.0)
            try:
                with tracer.span(f"verify{verified + 1}"):
                    x_c, eps = self._certificate_lp(keep, b_eq, stage.level,
                                                    stats)
            except RuntimeError:
                break     # infeasible under the new rhs: re-solve from here
            if (eps > _BLOCK_RTOL * max(stage.level, 1e-300)).any():
                break     # someone traced-frozen is now raisable
            st.x_arc = x_c
            st.t_eq[keep] = self.r[keep] * stage.level
            frozen_before[keep] = True
            st.level = stage.level
            st.trace.append(_Stage(stage.level, keep))
            verified += 1
        stats.warm_hits = verified
        stats.stages = verified
        st.active = act_mask & ~frozen_before
        if st.active.any():
            self._run_stages(st, stats, tracer)
        return self._store(st, act_mask, stats, tracer, t0), stats

    def update(self, level_gamma: Optional[np.ndarray] = None,
               capacity_scale: Optional[np.ndarray] = None) -> bool:
        """Re-parameterize rates and/or per-server capacity multipliers.

        Returns True when the cached trace survived (nothing actually
        changed), False when it was dropped — the next ``resolve`` then
        runs a full solve and reports ``warm_fallbacks``. Raises
        ``ValueError`` if the eligibility support changed (the arc
        topology is baked into the matrices; build a fresh ``RouterState``).
        """
        if self.net is None:
            return True
        changed = False
        if capacity_scale is not None:
            scale = np.asarray(capacity_scale, dtype=np.float64)
            if not np.allclose(scale, self._cap_vec, rtol=0, atol=0):
                self._cap_vec = scale.copy()
                self.rhs_cap = self.net.b_cap * scale[self.net.row_server]
                changed = True
        if level_gamma is not None:
            if ((level_gamma > 0) != self.support).any():
                raise ValueError(
                    "eligibility support changed; build a new RouterState")
            rate = _level_rates_np(self.problem, level_gamma)
            r = rate[self.users] / rate[self.users].max()
            if not np.allclose(r, self.r, rtol=1e-12, atol=0):
                self.r = r
                # the cached increment column bakes in -r; refresh it
                self.a_inc.data[self._dcol] = -self.r
                changed = True
        if changed and self._trace is not None:
            self._trace = None
            self._invalidated = True   # the next resolve reports a fallback
        return not changed

    @property
    def trace_stages(self) -> int:
        """Number of stages in the cached trace (0 if none)."""
        return 0 if not self._trace else len(self._trace)


def _level_rates_np(problem: AllocationProblem,
                    level_gamma: np.ndarray) -> np.ndarray:
    """Validate server-independence and return per-user level rates."""
    lg_max = level_gamma.max(axis=1, initial=0.0)
    spread = np.where(level_gamma > 0,
                      np.abs(level_gamma - lg_max[:, None]), 0.0)
    if (spread > _RATE_RTOL * np.maximum(lg_max[:, None], 1e-300)).any():
        raise ValueError(
            "lexmm requires a server-independent level rate per user (the "
            "global-share mechanisms); per-server-rate mechanisms route "
            "through the level fill instead")
    return problem.weights * lg_max                   # tasks per unit level


def lexmm_route_np(problem: AllocationProblem, level_gamma: np.ndarray
                   ) -> Tuple[np.ndarray, int]:
    """Exact lexicographic max-min fill with optimal routing.

    ``level_gamma[n, i]`` is the mechanism's level rate of user n on server
    i — ``w_n`` masked by eligibility for the global-share mechanisms (the
    router requires it server-independent per user and refuses otherwise).
    Returns ``(x (N, K), stages)`` where ``stages`` counts the certified
    common-level increments (one per freeze batch, <= N).

    One-shot convenience over ``RouterState`` (matrix-warm, dual-seeded —
    identical allocations to ``lexmm_route_cold_np``, fewer LPs); callers
    that re-solve under churn should hold a ``RouterState`` instead.
    """
    router = RouterState(problem, level_gamma)
    x, stats = router.solve()
    return x, stats.stages


def _solve_lp_np(linprog, sparse, net: RoutingNetwork, cols, obj, b_eq):
    """One certificate LP: arc variables plus ``cols`` slack columns hooked
    into the user-total equalities. ``cols`` is a list of ``(rows, coeffs)``
    array pairs — extra column j subtracts ``coeffs`` from the user rows
    ``rows`` (one shared delta column spans every active row; a per-user
    slack column spans just its own row)."""
    p = net.num_arcs
    extra = len(cols)
    a_eq = net.a_user
    a_ub = net.a_cap
    if extra:
        row_idx = np.concatenate([np.atleast_1d(r) for r, _ in cols])
        col_idx = np.concatenate(
            [np.full(np.atleast_1d(r).shape[0], j)
             for j, (r, _) in enumerate(cols)])
        data = -np.concatenate([np.atleast_1d(c) for _, c in cols])
        eq_cols = sparse.csr_matrix((data, (row_idx, col_idx)),
                                    shape=(a_eq.shape[0], extra))
        a_eq = sparse.hstack([a_eq, eq_cols], format="csr")
        a_ub = sparse.hstack(
            [a_ub, sparse.csr_matrix((a_ub.shape[0], extra))], format="csr")
    c = np.zeros(p + extra)
    c[p:] = obj
    res = linprog(c, A_ub=a_ub, b_ub=net.b_cap, A_eq=a_eq, b_eq=b_eq,
                  bounds=(0, None), method="highs")
    if res.status != 0:
        raise RuntimeError(
            f"lexmm certificate LP failed (status {res.status}): "
            f"{res.message}")
    return res.x[:p], res.x[p:]


def lexmm_route_cold_np(problem: AllocationProblem,
                        level_gamma: np.ndarray) -> Tuple[np.ndarray, int]:
    """The original one-shot router, kept verbatim as the comparator for
    the warm path (every stage rebuilds its LP columns and runs the full
    per-candidate shrink loop through the public ``linprog``): the warm
    path's per-user totals are held to it at 1e-6 x max(1, max total).
    """
    linprog, sparse = _highs_np()
    n, k = level_gamma.shape
    rate = _level_rates_np(problem, level_gamma)
    in_scope = rate > 0
    if not in_scope.any():
        return np.zeros((n, k)), 0

    users = np.nonzero(in_scope)[0]
    net = RoutingNetwork(problem, level_gamma > 0, users)
    # arc variables are in cap_scale-normalized task units and rates are
    # max-normalized, so every LP coefficient is O(1) no matter how the
    # instance is scaled (the internal level absorbs both factors;
    # scatter() undoes the capacity one at the end)
    r_scaled = rate[users] / rate[users].max()
    t_eq = np.zeros(users.shape[0])                   # frozen totals (scaled)
    active = np.ones(users.shape[0], dtype=bool)
    level = 0.0
    stages = 0
    x_arc = np.zeros(net.num_arcs)

    while active.any():
        stages += 1
        if stages > users.shape[0] + 1:               # theory: <= |users|
            raise RuntimeError("lexmm did not converge in |users| stages")
        act_idx = np.nonzero(active)[0]
        # --- certify the largest common increment delta ------------------
        # one shared delta column subtracts rate_u from every active row
        b_eq = np.where(active, r_scaled * level, t_eq)
        x_arc, extra = _solve_lp_np(
            linprog, sparse, net,
            [(act_idx, r_scaled[act_idx])], np.array([-1.0]), b_eq)
        delta = float(extra[0])
        level += delta
        # --- freeze the blocked users at the certified level -------------
        cand = act_idx.copy()
        b_eq = np.where(active, r_scaled * level, t_eq)
        while cand.size:
            cols = [(np.array([u]), np.array([r_scaled[u]])) for u in cand]
            _, eps = _solve_lp_np(linprog, sparse, net, cols,
                               np.full(cand.size, -1.0), b_eq)
            raisable = eps > _BLOCK_RTOL * max(level, 1e-300)
            if not raisable.any():
                break                                 # all remaining blocked
            cand = cand[~raisable]
        blocked = cand
        if blocked.size == 0:
            # cannot happen for a polytope (see module docstring); freeze
            # everyone rather than loop forever if fp noise defeats the
            # certificate
            blocked = act_idx
        t_eq[blocked] = r_scaled[blocked] * level
        active[blocked] = False

    return net.scatter(x_arc, (n, k)), stages
