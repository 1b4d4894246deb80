"""Multi-tenant serving dispatch via PS-DSF: the port of
``repro/sched/serving.py``.

Tenants share heterogeneous inference replica groups. Resources per group:
[decode slots, KV-cache GB, prefill tokens/s]. A tenant's per-request
demand depends on its model/context profile; placement constraints arise
naturally (a 32k-context tenant cannot run on a group provisioned for 4k
KV). PS-DSF assigns per-tenant admitted request rates per group, with the
paper's sharing-incentive and bottleneck-fairness guarantees at the
serving layer.

The fleet model and ``dispatch_problem`` are host numpy, copied from the
reference (same arrays, bit for bit). ``admitted_rates`` solves through the
port's ``engine.solve`` on ``device`` (default ``cuda``) with its keyword
set, the reference's JAX backend's (``max_rounds=256, tol=1e-6`` by
default; ``fill``, ``round``, ``layout``, ``accel`` accepted; the numpy
solvers' ``adaptive_damping`` and ``server_order`` raise ``TypeError``).
``DynamicDispatcher`` ticks the port's ``DistributedPSDSF`` on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from ..core.dynamic import DistributedPSDSF
from ..core.engine import ensure_converged, solve
from ..core.types import AllocationProblem
from ..device import DeviceLike

SERVE_RESOURCES = ("decode_slots", "kv_gb", "prefill_tps")


@dataclasses.dataclass
class ReplicaGroup:
    """A pool of identical model replicas — the serving-layer "server",
    with capacity over ``SERVE_RESOURCES``."""

    name: str
    decode_slots: float          # concurrent sequences
    kv_gb: float                 # HBM available for KV cache
    prefill_tps: float           # prefill token throughput
    max_context: int

    def capacity(self) -> np.ndarray:
        """Capacity vector over ``SERVE_RESOURCES``."""
        return np.array([self.decode_slots, self.kv_gb, self.prefill_tps])


@dataclasses.dataclass
class Tenant:
    """One serving tenant; a "task" is one concurrent in-flight request
    with its KV and prefill footprint."""

    name: str
    weight: float
    context_len: int
    kv_gb_per_req: float
    prefill_tokens_per_req: float

    def demand(self) -> np.ndarray:
        """Per-request demand vector over ``SERVE_RESOURCES``."""
        return np.array([1.0, self.kv_gb_per_req,
                         self.prefill_tokens_per_req])

    def eligible(self, g: ReplicaGroup) -> bool:
        """Whether group ``g``'s context window fits this tenant."""
        return g.max_context >= self.context_len


def dispatch_problem(groups: Sequence[ReplicaGroup],
                     tenants: Sequence[Tenant]) -> AllocationProblem:
    """Assemble the PS-DSF :class:`AllocationProblem` for request dispatch
    across replica groups (eligibility = context-window fit)."""
    return AllocationProblem(
        demands=np.stack([t.demand() for t in tenants]),
        capacities=np.stack([g.capacity() for g in groups]),
        weights=np.array([t.weight for t in tenants]),
        eligibility=np.array([[1.0 if t.eligible(g) else 0.0 for g in groups]
                              for t in tenants]))


def admitted_rates(groups: Sequence[ReplicaGroup],
                   tenants: Sequence[Tenant],
                   mechanism: str = "psdsf-rdm",
                   placement: str = "level", *, device: DeviceLike = None,
                   **solver_kw) -> Dict[str, Dict[str, float]]:
    """tenant -> group -> concurrent requests admitted, under any
    placement-aware mechanism of ``engine.solve`` (default PS-DSF/RDM) and
    placement strategy (default the exact level fill), solved on
    ``device`` (default ``cuda``). Convergence is enforced by
    ``ensure_converged`` (raises ``ConvergenceError``); a pooled mechanism
    (drf) yields no per-group placement and raises ``ValueError``."""
    prob = dispatch_problem(groups, tenants)
    alloc, info = solve(prob, mechanism, placement=placement, device=device,
                        **solver_kw)
    ensure_converged(info, what=f"{mechanism} serving dispatch")
    # pooled mechanisms (drf) return an allocation on a DIFFERENT problem
    # (the substitutability relaxation, eligibility dropped): an identity
    # check, not a shape check, so a single-group fleet can't slip through
    if alloc.problem is not prob:
        raise ValueError(
            f"mechanism {mechanism!r} solves a pooled relaxation and yields "
            f"no per-group placement; pick a placement-aware allocator")
    return {t.name: {g.name: float(alloc.x[ti, gi])
                     for gi, g in enumerate(groups)}
            for ti, t in enumerate(tenants)}


class DynamicDispatcher:
    """Asynchronous per-group PS-DSF ticks for tenant churn (Section III-D /
    the Section V experiment, at the serving layer), on ``device``
    (default ``cuda``).

    ``engine``/``precision``/``placement``/``fill``/``layout``/``accel``
    thread straight through to the port's ``DistributedPSDSF``; a
    dispatcher ticked to equilibrium reproduces
    ``admitted_rates(..., mechanism="psdsf-<mode>")`` quotas.

    Two defaults differ from the reference's: ``engine="torch"`` (the
    port's tick engine; the reference's ``engine="numpy"`` oracle stays in
    the reference and raises ``NotImplementedError`` here), and so
    ``precision="highest"`` ticks in float64 on the device, which the
    reference's JAX engine cannot (its float64 scope uses an API jax
    removed); ``"fast"`` ticks in float32.
    """

    def __init__(self, groups: Sequence[ReplicaGroup],
                 tenants: Sequence[Tenant], mode: str = "rdm",
                 engine: str = "torch", precision: str = "highest",
                 placement: str = "level", fill: str = "event",
                 layout: str = "auto", accel: str = "none",
                 device: DeviceLike = None):
        self.groups = list(groups)
        self.tenants = list(tenants)
        self.sim = DistributedPSDSF(dispatch_problem(groups, tenants), mode,
                                    engine=engine, precision=precision,
                                    placement=placement, fill=fill,
                                    layout=layout, accel=accel,
                                    device=device)

    def set_active(self, tenant_name: str, active: bool):
        """Tenant arrival/departure by name (delegates to the simulator)."""
        idx = [t.name for t in self.tenants].index(tenant_name)
        self.sim.set_active(idx, active)

    def tick(self, groups=None):
        """One asynchronous PS-DSF round over ``groups`` (all by default)."""
        self.sim.tick(groups)

    def quotas(self) -> Dict[str, Dict[str, float]]:
        """Current concurrency quotas as {tenant: {group: requests}}."""
        return {t.name: {g.name: float(self.sim.x[ti, gi])
                         for gi, g in enumerate(self.groups)}
                for ti, t in enumerate(self.tenants)}

    def routed_quotas(self, mechanism: str = "tsf"
                      ) -> Dict[str, Dict[str, float]]:
        """Exact flow-routed quotas of a global-share comparator under the
        current tenant activity: the serving-layer face of
        ``DistributedPSDSF.routed_allocation`` (one persistent warm host
        router; ``set_active`` churn arrives as an activity delta, and
        ``self.sim.router_stats`` tells which path ran)."""
        alloc = self.sim.routed_allocation(mechanism)
        return {t.name: {g.name: float(alloc.x[ti, gi])
                         for gi, g in enumerate(self.groups)}
                for ti, t in enumerate(self.tenants)}

    def utilization(self) -> np.ndarray:
        """(groups, resources) utilization of the current quotas."""
        return self.sim.utilization()
