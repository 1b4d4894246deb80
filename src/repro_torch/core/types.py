"""Problem/solution containers for multi-resource fair allocation (the
port's own copy of ``repro.core.types``; same validation, same fields).

Notation follows the paper:
  N users, K servers, R resource types.
  demands     d[n, r]     per-task demand of user n for resource r (>= 0,
                          some r > 0)
  capacities  c[i, r]     capacity of resource r on server i (>= 0)
  weights     phi[n]      user weight (> 0)
  eligibility delta[n, i] in {0, 1}; implicit ineligibility (d[n,r] > 0
                          while c[i,r] == 0) is folded into gamma == 0.

The containers hold float64 numpy arrays, as the reference's do, so a
problem built from the same arrays is the same problem in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class AllocationProblem:
    """A static multi-resource allocation instance."""

    demands: Array          # (N, R) float
    capacities: Array       # (K, R) float
    weights: Optional[Array] = None        # (N,) float, default all-ones
    eligibility: Optional[Array] = None    # (N, K) {0,1}, default all-ones

    def __post_init__(self):
        d = np.asarray(self.demands, dtype=np.float64)
        c = np.asarray(self.capacities, dtype=np.float64)
        if d.ndim != 2 or c.ndim != 2 or d.shape[1] != c.shape[1]:
            raise ValueError(
                f"bad shapes: demands {d.shape}, capacities {c.shape}")
        if (d < 0).any() or (c < 0).any():
            raise ValueError("negative demand/capacity")
        if (d.sum(axis=1) <= 0).any():
            raise ValueError("every user must demand at least one resource")
        w = (np.ones(d.shape[0]) if self.weights is None
             else np.asarray(self.weights, dtype=np.float64))
        if w.shape != (d.shape[0],) or (w <= 0).any():
            raise ValueError("weights must be positive, shape (N,)")
        e = (np.ones((d.shape[0], c.shape[0])) if self.eligibility is None
             else np.asarray(self.eligibility, dtype=np.float64))
        if e.shape != (d.shape[0], c.shape[0]) or ((e != 0) & (e != 1)).any():
            raise ValueError("eligibility must be a (N, K) 0/1 matrix")
        object.__setattr__(self, "demands", d)
        object.__setattr__(self, "capacities", c)
        object.__setattr__(self, "weights", w)
        object.__setattr__(self, "eligibility", e)

    @property
    def num_users(self) -> int:
        """N — number of users (rows of ``demands``)."""
        return self.demands.shape[0]

    @property
    def num_servers(self) -> int:
        """K — number of servers (rows of ``capacities``)."""
        return self.capacities.shape[0]

    @property
    def num_resources(self) -> int:
        """R — number of resource types (columns of ``demands``)."""
        return self.demands.shape[1]

    def restrict_users(self, mask: Array) -> "AllocationProblem":
        """Sub-problem with only the users where ``mask[n]``."""
        mask = np.asarray(mask, dtype=bool)
        return AllocationProblem(
            demands=self.demands[mask],
            capacities=self.capacities,
            weights=self.weights[mask],
            eligibility=self.eligibility[mask],
        )


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Non-wasteful allocation: a[n, i] = x[n, i] * d[n]."""

    problem: AllocationProblem
    x: Array                # (N, K) tasks of user n on server i

    @property
    def tasks_per_user(self) -> Array:
        """x_n = sum_i x[n, i] — total tasks each user runs clusterwide."""
        return self.x.sum(axis=1)

    @property
    def usage(self) -> Array:
        """(K, R) consumed resources: usage[i, r] = sum_n x[n, i] d[n, r]."""
        return np.einsum("nk,nr->kr", self.x, self.problem.demands)

    def utilization(self) -> Array:
        """(K, R) usage / capacity in [0, 1]; zero-capacity cells map to 0."""
        cap = self.problem.capacities
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.where(cap > 0, self.usage / np.maximum(cap, 1e-300), 0.0)
        return u
