"""Fault-tolerance control plane: heartbeats, straggler detection, and the
checkpoint-restart-rescale loop. A copy of the reference's numpy module
``repro/ft/failures.py``: the port imports nothing of ``repro``.

On a real deployment these objects run in the per-pod launcher processes and
talk over the cluster control network; the logic is identical here and is
exercised by tests/benchmarks through the simulated clock. The re-solve is
the caller's ``solve_fn``: with the port's ``repro_torch.sched.schedule``
(``device`` bound by the caller) it runs ``engine.solve`` on the card.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional

import numpy as np


class HeartbeatMonitor:
    """Declares a worker dead after ``timeout_s`` without a heartbeat."""

    def __init__(self, workers: List[str], timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        self.last_seen: Dict[str, float] = {w: 0.0 for w in workers}

    def beat(self, worker: str, now: float):
        self.last_seen[worker] = now

    def dead(self, now: float) -> List[str]:
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout_s]

    def add(self, worker: str, now: float):
        self.last_seen[worker] = now

    def remove(self, worker: str):
        self.last_seen.pop(worker, None)


class StragglerDetector:
    """Flags workers whose recent step times exceed ``factor`` x the fleet
    median (the standard straggler rule; mitigation = re-shard its data or
    evict via the elastic controller)."""

    def __init__(self, window: int = 16, factor: float = 2.0):
        self.window = window
        self.factor = factor
        self.times: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.window))

    def record(self, worker: str, step_time_s: float):
        self.times[worker].append(step_time_s)

    def stragglers(self) -> List[str]:
        if not self.times:
            return []
        medians = {w: float(np.median(t)) for w, t in self.times.items()
                   if len(t) >= 3}
        if len(medians) < 2:
            return []
        fleet = float(np.median(list(medians.values())))
        return [w for w, m in medians.items() if m > self.factor * fleet]


@dataclasses.dataclass
class RestartEvent:
    time: float
    reason: str              # "failure" | "straggler" | "arrival" | "departure"
    worker: Optional[str]
    restored_step: int
    new_allocation: dict     # job -> replicas after PS-DSF re-solve


class ElasticController:
    """The checkpoint -> re-allocate -> restart loop.

    Owns: a HeartbeatMonitor over pods, a StragglerDetector over workers, a
    CheckpointManager per job, and the PS-DSF scheduler (via ``solve_fn``,
    e.g. ``repro_torch.sched.cluster.schedule``) that re-solves the
    allocation whenever
    membership changes. This is where the paper's mechanism becomes the
    framework's fault-tolerance policy: a failed pod is removed from the
    AllocationProblem's capacity matrix, the distributed server procedure
    re-runs, and every affected job restarts from its latest checkpoint at
    its new replica count.
    """

    def __init__(self, cluster, jobs, solve_fn: Callable,
                 heartbeat_timeout_s: float = 30.0):
        self.cluster = cluster          # sched.cluster.Cluster
        self.jobs = jobs                # list[sched.cluster.TenantJob]
        self.solve_fn = solve_fn
        self.monitor = HeartbeatMonitor([p.name for p in cluster.pods],
                                        heartbeat_timeout_s)
        self.stragglers = StragglerDetector()
        self.events: List[RestartEvent] = []
        self.allocation = self.solve_fn(self.cluster, self.jobs)

    def on_tick(self, now: float, restored_steps: Dict[str, int]):
        """Periodic control-plane tick: detect failures, re-solve, restart."""
        dead = self.monitor.dead(now)
        changed = False
        for pod in dead:
            if self.cluster.mark_failed(pod):
                self.events.append(RestartEvent(
                    now, "failure", pod, restored_steps.get(pod, 0), {}))
                changed = True
        for w in self.stragglers.stragglers():
            # mitigation: deprioritize the straggler pod (halve its capacity)
            if self.cluster.degrade(w, 0.5):
                self.events.append(RestartEvent(
                    now, "straggler", w, restored_steps.get(w, 0), {}))
                changed = True
        if changed:
            self.allocation = self.solve_fn(self.cluster, self.jobs)
            if self.events:
                self.events[-1].new_allocation = dict(self.allocation)
        return self.allocation
