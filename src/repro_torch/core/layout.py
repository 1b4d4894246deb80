"""Sparse-eligibility bucket layout: the port's own copy of
``repro/core/layout.py`` (numpy, bit-identical results).

At datacenter density a server is eligible for a few percent of the users,
so the dense solve's (N, K) arrays carry mostly zeros. ``BucketedLayout``
stores, per server, just the users eligible on it: ``indices``/``mask`` are
padded (K, Bmax) int32/bool arrays, every row a prefix of a permutation of
0..N-1 (eligible users first, ascending), so the padded slots hold distinct
user ids with ``mask`` False and per-server gathers and scatter-adds never
collide. ``user_ptr``/``user_servers`` is the transposed user -> servers
adjacency. ``resolve_layout`` maps the public ``layout="auto"`` knob to
"dense" or "bucketed" by a density threshold, as in the reference.

The reference's ``from_cluster`` builds from a ``sched.cluster.Cluster``,
which the port does not have yet (ROADMAP.md queue 1 item 6, scheduler
consumers).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .types import AllocationProblem

#: public layout axis accepted by the solvers ("auto" resolves by density)
LAYOUTS = ("dense", "bucketed", "auto")

#: ``layout="auto"`` picks the bucketed path at or below this density...
AUTO_DENSITY_MAX = 0.25

#: ...but only on instances at least this big (tiny ones resolve dense)
AUTO_MIN_USERS = 64
AUTO_MIN_SERVERS = 8


@dataclasses.dataclass(frozen=True)
class BucketedLayout:
    """Per-server user buckets of one eligibility support (see module doc).

    ``indices[i, :counts[i]]`` are the users eligible on server i (sorted
    ascending); ``indices[i, counts[i]:]`` is padding (distinct user ids
    with ``mask`` False). User n's servers are
    ``user_servers[user_ptr[n]:user_ptr[n + 1]]``.
    """

    indices: np.ndarray       # (K, Bmax) int32
    mask: np.ndarray          # (K, Bmax) bool
    counts: np.ndarray        # (K,) int32
    num_users: int
    user_ptr: np.ndarray      # (N + 1,) int64
    user_servers: np.ndarray  # (nnz,) int32

    @classmethod
    def from_support(cls, support: np.ndarray) -> "BucketedLayout":
        """Build from an (N, K) boolean/0-1 support matrix."""
        supp = np.asarray(support) > 0
        if supp.ndim != 2:
            raise ValueError(f"support must be (N, K): {supp.shape}")
        n, _ = supp.shape
        counts = supp.sum(axis=0).astype(np.int32)
        bmax = max(int(counts.max(initial=0)), 1)
        # stable argsort of ~support per column: eligible users first, in
        # ascending order, and the padding still DISTINCT user ids
        order = np.argsort(~supp, axis=0, kind="stable")      # (N, K)
        indices = np.ascontiguousarray(order[:bmax].T).astype(np.int32)
        mask = np.ascontiguousarray(
            np.take_along_axis(supp, order[:bmax], axis=0).T)
        srv_of, usr_of = np.nonzero(supp.T)
        perm = np.argsort(usr_of, kind="stable")
        user_servers = srv_of[perm].astype(np.int32)
        user_ptr = np.searchsorted(usr_of[perm], np.arange(n + 1))
        return cls(indices=indices, mask=mask, counts=counts, num_users=n,
                   user_ptr=user_ptr.astype(np.int64),
                   user_servers=user_servers)

    @classmethod
    def from_problem(cls, problem: AllocationProblem,
                     gamma: Optional[np.ndarray] = None) -> "BucketedLayout":
        """Build from a problem's eligibility, or from an explicit gamma
        (its support coincides with eligibility)."""
        supp = problem.eligibility if gamma is None else gamma
        return cls.from_support(np.asarray(supp) > 0)

    @property
    def num_servers(self) -> int:
        """K, the number of server buckets."""
        return int(self.indices.shape[0])

    @property
    def bucket_max(self) -> int:
        """Bmax, the padded bucket width (largest per-server user count)."""
        return int(self.indices.shape[1])

    @property
    def nnz(self) -> int:
        """Number of (user, server) eligibility pairs."""
        return int(self.counts.sum())

    @property
    def density(self) -> float:
        """nnz / (N * K); 0.0 for a degenerate empty support."""
        cells = self.num_users * self.num_servers
        return self.nnz / cells if cells else 0.0

    def bucket_users(self, i: int) -> np.ndarray:
        """Server i's user-index list (ascending, no padding)."""
        return self.indices[i, :int(self.counts[i])]

    def bucket_lists(self) -> List[np.ndarray]:
        """All per-server user-index lists (views into ``indices``)."""
        return [self.bucket_users(i) for i in range(self.num_servers)]

    def servers_of(self, users: np.ndarray) -> np.ndarray:
        """Concatenated server lists of ``users`` (with duplicates)."""
        users = np.asarray(users, dtype=np.int64)
        lens = self.user_ptr[users + 1] - self.user_ptr[users]
        total = int(lens.sum())
        if total == 0:
            return self.user_servers[:0]
        starts = self.user_ptr[users]
        offs = np.repeat(starts - np.insert(np.cumsum(lens)[:-1], 0, 0), lens)
        return self.user_servers[offs + np.arange(total)]

    def gather(self, x: np.ndarray) -> np.ndarray:
        """Dense (N, K) -> padded (K, Bmax) buckets (padding zeroed)."""
        xb = np.take_along_axis(np.asarray(x).T, self.indices, axis=1)
        return np.where(self.mask, xb, 0.0)

    def scatter(self, xb: np.ndarray) -> np.ndarray:
        """Padded (K, Bmax) buckets -> dense (N, K) (padding dropped)."""
        x = np.zeros((self.num_users, self.num_servers),
                     dtype=np.asarray(xb).dtype)
        cols = np.broadcast_to(
            np.arange(self.num_servers)[:, None], self.indices.shape)
        x[self.indices[self.mask], cols[self.mask]] = np.asarray(xb)[self.mask]
        return x


def resolve_layout(layout: str, problem: Optional[AllocationProblem] = None,
                   support: Optional[np.ndarray] = None) -> str:
    """Map the public ``layout`` knob to a concrete "dense"/"bucketed":
    ``"auto"`` is "bucketed" when the support's density is at most
    ``AUTO_DENSITY_MAX`` on an instance of at least ``AUTO_MIN_USERS`` x
    ``AUTO_MIN_SERVERS``, else "dense"; unknown names raise."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}: {layout!r}")
    if layout != "auto":
        return layout
    supp = (np.asarray(support) > 0 if support is not None
            else np.asarray(problem.eligibility) > 0)
    n, k = supp.shape
    if n < AUTO_MIN_USERS or k < AUTO_MIN_SERVERS:
        return "dense"
    density = supp.mean() if supp.size else 0.0
    return "bucketed" if density <= AUTO_DENSITY_MAX else "dense"
