"""Problem instances: the paper's worked examples and the scale pins.

The port's own copy of the generators in ``repro.core.instances``. Each
draws from ``numpy.random.default_rng(seed)`` in exactly the reference's
order, so the same arguments give bit-identical arrays in both packages
(pinned by tests/test_torch_solve.py).
"""
from __future__ import annotations

import numpy as np

from .types import AllocationProblem


def fig1_instance() -> AllocationProblem:
    """The paper's Fig. 1 example: 3 users, 2 heterogeneous servers
    (server 2 has no resource-3 capacity), user 3 weighted 2x."""
    return AllocationProblem(
        demands=np.array([[1.0, 2.0, 10.0], [1.0, 2.0, 1.0],
                          [1.0, 2.0, 0.0]]),
        capacities=np.array([[9.0, 12.0, 100.0], [12.0, 12.0, 0.0]]),
        weights=np.array([1.0, 1.0, 2.0]))


def fig2_instance() -> AllocationProblem:
    """The paper's Fig. 2 example: 4 users on the same 2 servers."""
    return AllocationProblem(
        demands=np.array([[1.5, 1.0, 10.0], [1.0, 2.0, 10.0],
                          [0.5, 1.0, 0.0], [1.0, 0.5, 0.0]]),
        capacities=np.array([[9.0, 12.0, 100.0], [12.0, 12.0, 0.0]]))


def dense_random_instance(num_users: int = 60, num_servers: int = 12,
                          num_resources: int = 4, elig_frac: float = 0.7,
                          seed: int = 0) -> AllocationProblem:
    """Dense random eligibility (each pair eligible with probability
    ``elig_frac``) with heterogeneous demand mixes: the contended 60x12
    instance the reference pins its placement and fill tests on."""
    rng = np.random.default_rng(seed)
    return AllocationProblem(
        demands=rng.uniform(0.05, 2.0, (num_users, num_resources)),
        capacities=rng.uniform(5.0, 50.0, (num_servers, num_resources)),
        weights=rng.uniform(0.5, 2.0, num_users),
        eligibility=(rng.random((num_users, num_servers))
                     > 1.0 - elig_frac).astype(float))


def cell_cluster_instance(num_users: int = 512, num_servers: int = 64,
                          num_resources: int = 4, cells: int = 8,
                          cross_frac: float = 0.1, seed: int = 0):
    """Datacenter-cell instance: each user is eligible on every server of
    one home cell, and a ``cross_frac`` fraction also on the next cell of
    the ring. Returns (problem, home_cell (N,), is_cross (N,))."""
    if num_servers % cells:
        raise ValueError(f"{num_servers} servers not divisible into {cells}")
    rng = np.random.default_rng(seed)
    kpc = num_servers // cells
    demands = rng.uniform(0.05, 2.0, (num_users, num_resources))
    caps = rng.uniform(5.0, 50.0, (num_servers, num_resources))
    weights = rng.uniform(0.5, 2.0, num_users)
    elig = np.zeros((num_users, num_servers))
    home = rng.integers(0, cells, num_users)
    is_cross = np.zeros(num_users, dtype=bool)
    for n in range(num_users):
        elig[n, home[n] * kpc:(home[n] + 1) * kpc] = 1.0
        if rng.random() < cross_frac:
            c2 = (int(home[n]) + 1) % cells
            elig[n, c2 * kpc:(c2 + 1) * kpc] = 1.0
            is_cross[n] = True
    return (AllocationProblem(demands, caps, weights, elig), home, is_cross)


def sparse_cell_instance(num_users: int = 20000, num_servers: int = 256,
                         density: float = 0.03, num_resources: int = 4,
                         cells: int = 16, multi_frac: float = 1.0,
                         seed: int = 0):
    """The datacenter pin: ~20k users x 256 servers x 4 resources at ~3%
    eligibility density in 16 cells. Each user draws a fixed number of
    servers from its 2-cell ring neighbourhood; ``multi_frac`` < 1 pins the
    rest of the users to a single server. Returns (problem, home (N,))."""
    if num_servers % cells:
        raise ValueError(f"{num_servers} servers not divisible into {cells}")
    if not 0.0 < multi_frac <= 1.0:
        raise ValueError(f"multi_frac must be in (0, 1]: {multi_frac}")
    kpc = num_servers // cells
    m_multi = max(1, round((density * num_servers - (1.0 - multi_frac))
                           / multi_frac))
    if m_multi > 2 * kpc:
        raise ValueError(
            f"density {density} needs {m_multi} servers/user but the "
            f"2-cell neighborhood only has {2 * kpc}")
    rng = np.random.default_rng(seed)
    demands = rng.uniform(0.05, 2.0, (num_users, num_resources))
    caps = rng.uniform(5.0, 50.0, (num_servers, num_resources))
    weights = rng.uniform(0.5, 2.0, num_users)
    home = rng.integers(0, cells, num_users)
    m = np.where(rng.random(num_users) < multi_frac, m_multi, 1)
    nbhd = (home[:, None] * kpc + np.arange(2 * kpc)[None, :]) % num_servers
    r = rng.random((num_users, 2 * kpc))
    thresh = np.sort(r, axis=1)[np.arange(num_users), m - 1][:, None]
    elig = np.zeros((num_users, num_servers))
    elig[np.arange(num_users)[:, None], nbhd] = (r <= thresh).astype(float)
    return AllocationProblem(demands, caps, weights, elig), home
