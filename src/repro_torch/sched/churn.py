"""Event-driven churn simulation over warm-started PS-DSF re-solves: the
port of ``repro/sched/churn.py``.

Users arrive and depart, servers degrade and recover, and the allocator
re-equilibrates after every batch of simultaneous events, warm-started from
the pre-event fixed point. Each re-solve runs on the device in float32, as
the reference's jitted one does: ``_resolve_torch`` builds the mechanism's
level rates (gamma for PS-DSF, ``baselines_torch.level_rate_matrix_torch``
for cdrfh/tsf/cdrf), masks them and the warm start by activity and calls
the port's sweep cores (``psdsf_torch._solve_core_torch`` /
``_solve_core_bucketed_torch``), so with ``fill="bisect",
round="jacobi"`` every round is one Hopper fill kernel call per saturation
event (``psdsf_fill`` on the dense layout, ``psdsf_fill_bucketed`` on the
bucketed one). ``placement="headroom"`` follows a PS-DSF re-solve with its
repack-and-refill passes and replaces a baseline's sweep by the routed
global fill. The per-step telemetry, the per-server min normalized VDS of
Eq. 16, goes through ``core.dynamic.min_vds_guarded`` and so launches the
``psdsf_vds`` kernel once a step on the card.

Not ported, and raising ``NotImplementedError`` with the ROADMAP item:
``placement="lexmm"`` for the baselines (queue 1 item 5, baselines: host
lexmm router).
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.baselines_torch import (LEXMM_NOT_PORTED, _routed,
                                    level_rate_matrix_torch)
from ..core.dynamic import min_vds_guarded
from ..core.gamma import gamma_matrix_torch
from ..core.engine import PSDSF_MECHANISMS
from ..core.layout import BucketedLayout, resolve_layout
from ..core.placement_torch import _repack_refill_core_torch
from ..core.psdsf_torch import (_solve_core_bucketed_torch, _solve_core_torch,
                                check_axes)
from ..core.solveinfo import fill_iter_budget
from ..core.types import Allocation, AllocationProblem
from ..device import DeviceLike, resolve_device, to_device

VALID_KINDS = ("arrival", "departure", "degrade", "restore")

#: sweep-based mechanisms the simulator maintains a fixed point for, as in
#: the reference (closed-form mechanisms, drf and uniform, have no
#: per-server sweep to warm)
TICKABLE_MECHANISMS = PSDSF_MECHANISMS + ("cdrfh", "tsf", "cdrf")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One state change. ``user`` for arrival/departure; ``server`` (+
    ``scale`` in (0, 1]) for degrade; ``server`` for restore."""
    time: float
    kind: str
    user: int = -1
    server: int = -1
    scale: float = 1.0

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")


@dataclasses.dataclass
class ChurnRecord:
    """Telemetry for one re-solve step (the reference's fields; the lexmm
    router's stay at their zero defaults, as on the reference's PS-DSF
    ticks)."""
    time: float
    n_events: int
    rounds: int              # rounds the (warm) re-solve took
    cold_rounds: int         # rounds a cold solve would take (-1 if untracked)
    residual: float
    active_users: int
    total_tasks: float
    solve_ms: float
    min_vds: float           # global min normalized VDS over servers (Eq. 16)
    bottleneck_server: int   # server attaining it
    lp_calls: int = 0
    warm_hits: int = 0
    warm_fallbacks: int = 0
    router_mode: str = ""
    fill_engine: str = ""    # "event" / "bisect"
    fill_iters: int = 0      # inner-iteration budget the re-solve spent
    layout: str = "dense"    # data layout the re-solve swept in
    bucket_max: int = 0      # widest eligibility bucket (0 when dense)
    layout_rebuilds: int = 0  # bucket rebuilds this step
    accel: str = "none"      # accelerator the re-solve swept under
    accel_hits: int = 0      # accepted Anderson candidates this step
    accel_rejects: int = 0   # safeguard fallbacks this step
    rounds_to_tol: int = 0   # rounds to the TIGHT tol (0 if not reached)


def _resolve_torch(demands, capacities, weights, eligibility, active,
                   cap_scale, x0, *, mechanism, max_rounds, tol, placement,
                   fill, round, layout, buckets, accel):
    """One re-solve (port of the jitted ``resolve`` of the reference's
    ``_resolve_fn``): effective capacities -> the mechanism's level rates
    (gamma for PS-DSF) masked by activity -> the warm-started sweep, with
    the acceptance band on the ACTIVE users' per-server gamma scale
    (``scale=g.max()``). On the bucketed layout departed users' slots go
    dark under ``mask & active[idx]``. ``placement="headroom"`` follows a
    PS-DSF sweep with the repack-and-refill passes and replaces a
    baseline's sweep by the one-shot routed fill (no warm start: there is
    no fixed point to warm)."""
    zero = torch.zeros((), dtype=demands.dtype, device=demands.device)
    caps_eff = capacities * cap_scale[:, None]
    g = torch.where(active[:, None],
                    gamma_matrix_torch(demands, caps_eff, eligibility), zero)
    psdsf = mechanism in PSDSF_MECHANISMS
    if psdsf:
        lg, mode = g, mechanism.removeprefix("psdsf-")
    else:
        lg = torch.where(active[:, None], level_rate_matrix_torch(
            demands, caps_eff, eligibility, mechanism), zero)
        mode = "rdm"
    if placement == "headroom" and not psdsf:
        return _routed(demands, caps_eff, weights, lg, accel)
    x0 = torch.zeros_like(g) if x0 is None else x0
    x0 = torch.where(active[:, None], x0, zero)
    kw = dict(scale=g.max(), fill=fill, round_mode=round, accel=accel)
    if layout == "bucketed":
        idx, mask = buckets
        out = _solve_core_bucketed_torch(
            demands, caps_eff, weights, lg, x0, idx, mask & active[idx],
            mode, max_rounds, tol, **kw)
    else:
        out = _solve_core_torch(demands, caps_eff, weights, lg, x0, mode,
                                max_rounds, tol, **kw)
    if placement == "headroom":
        out = _repack_refill_core_torch(
            demands, caps_eff, weights, g, *out[:3], mode, max_rounds, tol,
            fill=fill, round_mode=round) + tuple(out[3:])
    return out


class ChurnSimulator:
    """Maintains a sweep mechanism's fixed point through an event stream,
    on ``device`` (default ``cuda``).

    ``problem`` holds the full user population; ``initial_active`` masks
    who is present at t=0 (arrivals flip users on). ``mechanism``
    ("psdsf-rdm"/"psdsf-tdm", or the baselines "cdrfh"/"tsf"/"cdrf";
    ``mode`` "rdm"/"tdm" is the legacy alias for PS-DSF) picks what is
    maintained. Each step re-solves warm from the previous fixed point
    (``warm_start``); ``compare_cold=True`` also runs it cold and records
    the round-count gap. ``fill`` ("event"/"bisect"), ``round``
    ("gauss"/"jacobi") and ``accel`` ("none"/"anderson") pick the sweep's
    fill, outer iteration and accelerator, as in the reference.
    ``placement`` "level"; "lexmm", the identity on the PS-DSF level tick
    (the baselines' host lexmm router is not ported); "headroom", which
    follows a PS-DSF re-solve with repack-and-refill passes and routes a
    baseline through the one-shot global fill (dense only: a bucketed
    layout is rejected).

    ``layout`` ("dense"/"bucketed"/"auto") picks the sweep's data layout:
    buckets are built from the ACTIVE support at construction, departures
    mask bucket slots in place, and an arrival the layout never saw
    rebuilds it (counted in ``layout_rebuilds`` and on the record). "auto"
    resolves by the density of the initial active support.

    ``telemetry`` computes each step's min normalized VDS. The reference's
    ``interpret_vds`` argument (which picks the Pallas interpreter) is
    accepted and ignored: the device decides, the Hopper ``psdsf_vds``
    kernel on the card and its plain version on the CPU.
    """

    def __init__(self, problem: AllocationProblem, mode: Optional[str] = None,
                 warm_start: bool = True, compare_cold: bool = False,
                 max_rounds: int = 256, tol: float = 1e-6,
                 initial_active: Optional[np.ndarray] = None,
                 telemetry: bool = True, interpret_vds: bool = True,
                 mechanism: Optional[str] = None, placement: str = "level",
                 fill: str = "event", round: str = "gauss",
                 layout: str = "auto", accel: str = "none",
                 device: DeviceLike = None):
        del interpret_vds                  # the device decides
        if mode is not None and mechanism is not None:
            raise ValueError(
                "pass either the legacy mode= alias or mechanism=, not both")
        if mode is not None:
            if mode not in ("rdm", "tdm"):
                raise ValueError(f"mode must be 'rdm' or 'tdm': {mode!r}")
            mechanism = f"psdsf-{mode}"
        if mechanism is None:
            mechanism = "psdsf-rdm"
        if mechanism not in TICKABLE_MECHANISMS:
            raise ValueError(
                f"mechanism must be sweep-based, one of "
                f"{TICKABLE_MECHANISMS}: {mechanism!r}")
        mode = mechanism.removeprefix("psdsf-") \
            if mechanism in PSDSF_MECHANISMS else "rdm"
        check_axes(mode=mode, placement=placement, fill=fill, round=round,
                   layout=layout, accel=accel)
        psdsf = mechanism in PSDSF_MECHANISMS
        routed = placement == "headroom" and not psdsf
        if routed and layout == "bucketed":
            raise ValueError(
                "layout='bucketed' needs the per-server sweep; the routed "
                "headroom fill for global-share mechanisms is one-shot "
                "global: use layout='dense'")
        if placement == "lexmm" and not psdsf:
            raise NotImplementedError(
                f"placement='lexmm' for mechanism {mechanism!r} is not "
                f"ported to repro_torch yet: {LEXMM_NOT_PORTED}")
        self.device = dev = resolve_device(device)
        self.problem = problem
        self.mechanism = mechanism
        self.mode = mode
        self.placement = placement
        self.fill = fill
        self.round = round
        self.accel = accel
        self.warm_start = warm_start
        self.compare_cold = compare_cold
        self.max_rounds = max_rounds
        self.tol = tol
        self.telemetry = telemetry
        n, k = problem.num_users, problem.num_servers
        self.active = (np.ones(n, dtype=bool) if initial_active is None
                       else np.asarray(initial_active, dtype=bool).copy())
        self.cap_scale = np.ones(k)
        self.x = np.zeros((n, k))
        # float32 on the device, as the reference's jitted re-solve
        self._demands, self._caps, self._weights, self._elig = (
            to_device(a, dev, torch.float32)
            for a in (problem.demands, problem.capacities, problem.weights,
                      problem.eligibility))
        # float64 twins for the telemetry's gamma, which the reference
        # computes on the host in float64
        self._gamma_args = tuple(to_device(a, dev, torch.float64)
                                 for a in (problem.demands,
                                           problem.capacities,
                                           problem.eligibility))
        self._swept = not routed
        self.layout = "dense" if routed else resolve_layout(
            layout, support=(problem.eligibility > 0) & self.active[:, None])
        self._blayout = None
        self.layout_rebuilds = 0
        self._needs_rebuild = False
        if self.layout == "bucketed":
            self._build_buckets()

    def _build_buckets(self) -> None:
        supp = (self.problem.eligibility > 0) & self.active[:, None]
        self._blayout = BucketedLayout.from_support(supp)
        self._covered = self.active.copy()     # users the layout has slots for
        self._idx = to_device(self._blayout.indices, self.device).long()
        self._mask = to_device(self._blayout.mask, self.device)
        self._needs_rebuild = False

    # -- event application --------------------------------------------------
    def _apply(self, ev: ChurnEvent) -> None:
        if ev.kind == "arrival":
            self.active[ev.user] = True
            if self._blayout is not None and not self._covered[ev.user]:
                self._needs_rebuild = True
        elif ev.kind == "departure":
            self.active[ev.user] = False
            self.x[ev.user, :] = 0.0
        elif ev.kind == "degrade":
            if not 0.0 < ev.scale <= 1.0:
                raise ValueError(
                    f"degrade scale must be in (0, 1]: {ev.scale}")
            self.cap_scale[ev.server] = ev.scale
        elif ev.kind == "restore":
            self.cap_scale[ev.server] = 1.0

    def _solve(self, x0) -> tuple[np.ndarray, int, float, int, int]:
        dev = self.device
        out = _resolve_torch(
            self._demands, self._caps, self._weights, self._elig,
            to_device(self.active, dev, torch.bool),
            to_device(self.cap_scale, dev, torch.float32),
            None if x0 is None else to_device(x0, dev, torch.float32),
            mechanism=self.mechanism, max_rounds=self.max_rounds,
            tol=self.tol, placement=self.placement, fill=self.fill,
            round=self.round, layout=self.layout,
            buckets=(None if self._blayout is None
                     else (self._idx, self._mask)),
            accel=self.accel)
        x, rounds, resid = out[0], out[1], out[2]
        hits, rejects = ((int(out[3]), int(out[4]))
                         if self.accel == "anderson" else (0, 0))
        return (x.to(torch.float64).cpu().numpy(), int(rounds), float(resid),
                hits, rejects)

    def step(self, events: Sequence[ChurnEvent], time_now: float
             ) -> ChurnRecord:
        """Apply simultaneous events, re-solve, record telemetry."""
        for ev in events:
            self._apply(ev)
        rebuilds = 0
        if self._needs_rebuild:
            # an arrival outside the layout: rebuild from the new active
            # support, counted so streams can budget for it
            self._build_buckets()
            self.layout_rebuilds += 1
            rebuilds = 1
        t0 = _time.perf_counter()
        x, rounds, resid, hits, rejects = self._solve(
            self.x if self.warm_start else None)
        solve_ms = (_time.perf_counter() - t0) * 1e3
        cold_rounds = -1
        if self.compare_cold and self.warm_start:
            _, cold_rounds, *_ = self._solve(None)
        self.x = x
        # one float64 gamma of the degraded capacities serves the telemetry
        # and the tight-tol certificate
        g = self._gamma()
        mn, arg = (self._min_vds(g) if self.telemetry else (np.inf, -1))
        swept = self._swept         # the routed fill runs no per-server one
        budget = (rounds * self.problem.num_servers * fill_iter_budget(
            self.problem.num_resources, self.mode, self.fill)
            if swept else 0)
        if swept:
            # tight-tol certification against the same active-gamma scale
            # the sweep accepts on
            active = to_device(self.active, self.device, torch.bool)
            g_act = torch.where(active[:, None], g, torch.zeros_like(g))
            tight = resid <= self.tol * max(
                1.0, float(g_act.max()) if g_act.numel() else 0.0)
        else:
            tight = resid == 0.0     # the routed fill is one-shot exact
        return ChurnRecord(
            time=time_now, n_events=len(events), rounds=rounds,
            cold_rounds=cold_rounds, residual=resid,
            active_users=int(self.active.sum()),
            total_tasks=float(self.x.sum()), solve_ms=solve_ms,
            min_vds=float(mn), bottleneck_server=int(arg),
            fill_engine=self.fill if swept else "",
            fill_iters=budget, layout=self.layout if swept else "dense",
            bucket_max=(self._blayout.bucket_max if swept
                        and self._blayout is not None else 0),
            layout_rebuilds=rebuilds,
            accel=self.accel if swept else "none",
            accel_hits=hits, accel_rejects=rejects,
            rounds_to_tol=rounds if tight else 0)

    def run(self, events: Sequence[ChurnEvent]) -> List[ChurnRecord]:
        """Consume a whole stream: batch same-timestamp events, one re-solve
        per batch (events must be time-sorted)."""
        records = []
        i, evs = 0, sorted(events, key=lambda e: e.time)
        while i < len(evs):
            j = i
            while j < len(evs) and evs[j].time == evs[i].time:
                j += 1
            records.append(self.step(evs[i:j], evs[i].time))
            i = j
        return records

    # -- telemetry ----------------------------------------------------------
    def _gamma(self) -> torch.Tensor:
        """(N, K) float64 gamma of the degrade-scaled capacities on the
        device: the values of the reference's host ``gamma_matrix`` of
        ``_effective_problem()``, without its host pass over (N, K, R)."""
        demands, capacities, eligibility = self._gamma_args
        scale = to_device(self.cap_scale, self.device, torch.float64)
        return gamma_matrix_torch(demands, capacities * scale[:, None],
                                  eligibility)

    def _min_vds(self, g: Optional[torch.Tensor] = None) -> tuple[float, int]:
        if g is None:
            g = self._gamma()
        mn, _ = min_vds_guarded(self.x, self.problem.weights, g, self.active,
                                device=self.device)
        mn = mn.cpu().numpy()
        i = int(np.argmin(mn))
        return float(mn[i]), i

    def _effective_problem(self) -> AllocationProblem:
        return AllocationProblem(
            self.problem.demands,
            self.problem.capacities * self.cap_scale[:, None],
            self.problem.weights, self.problem.eligibility)

    def allocation(self) -> Allocation:
        """Current allocation against the degrade-scaled capacities."""
        return Allocation(self._effective_problem(), self.x.copy())


def poisson_churn_events(n_users: int, n_servers: int, horizon: float,
                         arrival_rate: float = 0.5,
                         departure_rate: float = 0.5,
                         degrade_rate: float = 0.05,
                         seed: int = 0) -> List[ChurnEvent]:
    """Random event stream on integer timestamps (the scheduler's T-second
    grid): per tick, Poisson-many departures/arrivals of random users plus
    occasional server degrades/restores. The numpy draws are the
    reference's, in its order, so a seed gives the reference's stream."""
    rng = np.random.default_rng(seed)
    present = np.ones(n_users, dtype=bool)
    degraded: dict[int, bool] = {}
    events: List[ChurnEvent] = []
    for t in range(1, int(horizon) + 1):
        for _ in range(rng.poisson(departure_rate)):
            on = np.nonzero(present)[0]
            if on.size > 1:                      # keep >= 1 user active
                u = int(rng.choice(on))
                present[u] = False
                events.append(ChurnEvent(float(t), "departure", user=u))
        for _ in range(rng.poisson(arrival_rate)):
            off = np.nonzero(~present)[0]
            if off.size:
                u = int(rng.choice(off))
                present[u] = True
                events.append(ChurnEvent(float(t), "arrival", user=u))
        if rng.random() < degrade_rate:
            s = int(rng.integers(n_servers))
            if degraded.get(s):
                degraded[s] = False
                events.append(ChurnEvent(float(t), "restore", server=s))
            else:
                degraded[s] = True
                events.append(ChurnEvent(
                    float(t), "degrade", server=s,
                    scale=float(rng.uniform(0.3, 0.8))))
    return events
