"""PS-DSF over a heterogeneous accelerator fleet, the paper's mechanism as
the framework's cluster scheduler: the port of ``repro/sched/cluster.py``.

Servers   = TPU slices/pods with resource vectors
            [chips, HBM GB, host-DRAM GB, ICI GB/s, DCN GB/s].
Users     = tenant training/serving jobs; the per-task demand vector is the
            per-replica footprint, derived either by hand or directly from a
            dry-run artifact (bytes-per-device and collective traffic).
Placement = delta[n, i] from hard constraints (min HBM/chip, generation
            allow-list, multi-pod DCN requirement): the paper's
            heterogeneity + placement-constraint setting.

The fleet model and ``Cluster.problem`` are host numpy, copied from the
reference (same arrays, bit for bit). ``schedule``/``schedule_detail``
solve through the port's ``engine.solve`` on ``device`` (default
``cuda``) and take its keyword set, which is the reference's JAX
backend's: ``max_rounds=256, tol=1e-6`` by default, and ``fill``,
``round``, ``layout``, ``accel``, ``x0`` and ``loose_tol``; the numpy
solvers' knobs (``adaptive_damping``, ``server_order``) raise
``TypeError``. With ``fill="bisect", round="jacobi"`` every round goes
through the Hopper fill kernels (``psdsf_fill`` dense, ``psdsf_fill_bucketed``
on the buckets).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.engine import ensure_converged, solve
from ..core.types import AllocationProblem
from ..device import DeviceLike

RESOURCES = ("chips", "hbm_gb", "host_gb", "ici_gbps", "dcn_gbps")


@dataclasses.dataclass
class TPUPod:
    """One accelerator pod — a heterogeneous PS-DSF "server" whose
    capacity vector spans chips/HBM/host/ICI/DCN (``RESOURCES``)."""

    name: str
    generation: str              # "v5e" | "v5p" | ...
    chips: int
    hbm_gb_per_chip: float
    host_gb: float
    ici_gbps: float              # aggregate intra-pod ICI
    dcn_gbps: float              # pod-to-pod
    healthy: bool = True
    capacity_scale: float = 1.0  # straggler mitigation degrades this

    def capacity(self) -> np.ndarray:
        """Capacity vector over ``RESOURCES`` (zeros when unhealthy,
        scaled by ``capacity_scale`` when degraded)."""
        if not self.healthy:
            return np.zeros(len(RESOURCES))
        return self.capacity_scale * np.array([
            self.chips, self.chips * self.hbm_gb_per_chip, self.host_gb,
            self.ici_gbps, self.dcn_gbps])


@dataclasses.dataclass
class TenantJob:
    """One tenant's training job: per-replica demand vector plus
    placement constraints (generation allow-list, HBM floor, DCN)."""

    name: str
    weight: float
    # per-replica demand vector
    chips: float
    hbm_gb: float
    host_gb: float
    ici_gbps: float
    dcn_gbps: float
    # placement constraints
    min_hbm_per_chip: float = 0.0
    generations: Optional[Sequence[str]] = None
    needs_dcn: bool = False

    def demand(self) -> np.ndarray:
        """Per-replica demand vector over ``RESOURCES``."""
        return np.array([self.chips, self.hbm_gb, self.host_gb,
                         self.ici_gbps, self.dcn_gbps])

    def eligible(self, pod: TPUPod) -> bool:
        """Whether this job's placement constraints admit ``pod``."""
        if self.generations and pod.generation not in self.generations:
            return False
        if pod.hbm_gb_per_chip < self.min_hbm_per_chip:
            return False
        if self.needs_dcn and pod.dcn_gbps <= 0:
            return False
        return True


def job_from_artifact(name: str, artifact_path: str, weight: float = 1.0,
                      replica_chips: int = 256,
                      hbm_per_chip_gb: float = 16.0,
                      **constraints) -> TenantJob:
    """Derive a job's per-replica demand vector from a dry-run artifact
    (a JSON file with ``memory_analysis`` and ``collectives``)."""
    art = json.loads(Path(artifact_path).read_text())
    mem = art["memory_analysis"]
    # SPMD module sizes are already per-device
    per_dev_gb = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                  + mem["output_size_in_bytes"]) / 1e9
    wire = sum(c.get("wire_bytes", 0.0) for c in art["collectives"].values())
    return TenantJob(
        name=name, weight=weight, chips=replica_chips,
        hbm_gb=min(per_dev_gb, hbm_per_chip_gb) * replica_chips,
        host_gb=replica_chips * 0.5,
        ici_gbps=wire / 1e9,          # per-step wire bytes ~ sustained GB/s
        dcn_gbps=1.0 if constraints.get("needs_dcn") else 0.0,
        **constraints)


class Cluster:
    """A fleet of :class:`TPUPod` with failure/degrade mutation and a
    bridge to the core :class:`AllocationProblem` form."""

    def __init__(self, pods: List[TPUPod]):
        self.pods = pods

    def mark_failed(self, name: str) -> bool:
        """Mark pod ``name`` unhealthy; False if unknown/already failed."""
        for p in self.pods:
            if p.name == name and p.healthy:
                p.healthy = False
                return True
        return False

    def degrade(self, name: str, scale: float) -> bool:
        """Lower pod ``name``'s capacity scale to ``scale`` (stragglers);
        False if unknown or already at/below that scale."""
        for p in self.pods:
            if p.name == name and p.capacity_scale > scale:
                p.capacity_scale = scale
                return True
        return False

    def problem(self, jobs: Sequence[TenantJob]) -> AllocationProblem:
        """Assemble the PS-DSF :class:`AllocationProblem` for ``jobs`` on
        this cluster's current (health/degrade-adjusted) capacities."""
        demands = np.stack([j.demand() for j in jobs])
        caps = np.stack([p.capacity() for p in self.pods])
        # eligibility vectorized over jobs x pods: each constraint is one
        # broadcast predicate, the generation allow-list included
        hbm_pc = np.array([p.hbm_gb_per_chip for p in self.pods])
        dcn = np.array([p.dcn_gbps for p in self.pods])
        gens = np.array([p.generation for p in self.pods])
        min_hbm = np.array([j.min_hbm_per_chip for j in jobs])
        needs_dcn = np.array([j.needs_dcn for j in jobs])
        elig = (hbm_pc[None, :] >= min_hbm[:, None]).astype(float)
        elig *= ~needs_dcn[:, None] | (dcn[None, :] > 0)
        elig *= _generation_allowed_np(jobs, gens)
        weights = np.array([j.weight for j in jobs])
        return AllocationProblem(demands, caps, weights, elig)


def _generation_allowed_np(jobs: Sequence[TenantJob],
                           gens: np.ndarray) -> np.ndarray:
    """(J, K) 0/1: pod generation passes each job's allow-list.

    Allow-lists (tuples/lists or a plain str) are right-padded to a
    (J, G_max) array so one broadcast comparison covers every job at once;
    a validity mask keeps padding slots inert no matter what string a
    pod's generation is. Jobs with no allow-list — None, an empty
    sequence, or an empty string, exactly the falsy values
    ``TenantJob.eligible`` treats as unrestricted — accept every
    generation.
    """
    allow = [([j.generations] if isinstance(j.generations, str)
              else list(j.generations)) if j.generations else []
             for j in jobs]
    g_max = max((len(a) for a in allow), default=0)
    if g_max == 0:
        return np.ones((len(jobs), gens.shape[0]))
    padded = np.array([a + [""] * (g_max - len(a)) for a in allow])  # (J, G)
    lengths = np.array([len(a) for a in allow])
    valid = np.arange(g_max)[None, :] < lengths[:, None]             # (J, G)
    # np.isin(gens, padded[j]) for all j at once: (J, K, G) equality reduce
    match = ((gens[None, :, None] == padded[:, None, :])
             & valid[:, None, :]).any(axis=2)
    return (match | (lengths == 0)[:, None]).astype(float)


def _solve_placed_torch(cluster: Cluster, jobs: Sequence[TenantJob],
                        mechanism: str, placement: str, device: DeviceLike,
                        solver_kw):
    prob = cluster.problem(jobs)
    alloc, info = solve(prob, mechanism, placement=placement, device=device,
                        **solver_kw)
    ensure_converged(info, what=f"{mechanism} on cluster problem")
    # pooled mechanisms (drf) solve a relaxation that DROPS the placement
    # constraints (generation allow-list, min HBM/chip, DCN): their quotas
    # would be unplaceable, so reject them like the serving layer does
    if alloc.problem is not prob:
        raise ValueError(
            f"mechanism {mechanism!r} solves a pooled relaxation that drops "
            f"placement constraints; pick a placement-aware allocator")
    return alloc, info


def schedule(cluster: Cluster, jobs: Sequence[TenantJob],
             mechanism: str = "psdsf-rdm", placement: str = "level", *,
             device: DeviceLike = None, **solver_kw) -> Dict[str, float]:
    """Replica counts per job (continuous; launcher floors) under any
    placement-aware mechanism of ``engine.solve`` (default PS-DSF/RDM) and
    placement strategy (default the exact level fill), solved on
    ``device`` (default ``cuda``). ``solver_kw`` are ``engine.solve``'s
    (see the module docstring). Raises ``ConvergenceError`` outside the
    loose tolerance and ``ValueError`` for a pooled mechanism (drf)."""
    alloc, _ = _solve_placed_torch(cluster, jobs, mechanism, placement,
                                   device, solver_kw)
    return {j.name: float(x) for j, x in zip(jobs, alloc.tasks_per_user)}


def schedule_detail(cluster: Cluster, jobs: Sequence[TenantJob],
                    mechanism: str = "psdsf-rdm", placement: str = "level",
                    *, device: DeviceLike = None, **solver_kw):
    """Full ``(Allocation, SolveInfo)`` of :func:`schedule`: the info
    records the placement strategy, the resolved layout and the
    stranded-capacity fraction."""
    return _solve_placed_torch(cluster, jobs, mechanism, placement, device,
                               solver_kw)
