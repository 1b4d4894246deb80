"""The port's sharing-property checkers (``repro_torch.core.properties``)
against the reference's (``repro.core.properties``), on the CPU in
float64.

Instances are built like ``tests/test_properties.py::problems`` (random
heterogeneous demands with zero entries, capacities with the odd zero,
placement constraints, weights), from fixed numpy seeds. On each:

  * the reference's PS-DSF fixed points (RDM and TDM), random
    allocations that break the properties in every way, and planted
    violations of each kind (a negative entry, tasks on an ineligible
    server, a server over capacity, a user below its uniform share, an
    envied user, a server whose time shares sum below 1, a time share
    above 1, a server with no saturated resource: users with no
    bottleneck) go through both packages' checkers: the same ``ok``, the
    same detail text with its numbers within 1e-9 relative, so the same
    first offender;
  * the port's own solves (``engine.solve(..., device="cpu")``) of every
    registered mechanism satisfy the properties the reference's guarantee
    matrix lists for it (``ALLOCATOR_GUARANTEES_TORCH``, held equal to
    ``tests/test_properties.py::ALLOCATOR_GUARANTEES``);
  * ``utility_of_torch`` and ``weighted_max_min_check_torch`` equal the
    reference's.
"""
import re

import numpy as np
import pytest

from repro.core import properties as ref
from repro.core import solve_psdsf_rdm, solve_psdsf_tdm
from repro.core.types import Allocation as RefAllocation
from repro.core.types import AllocationProblem as RefProblem
from repro_torch.core import engine
from repro_torch.core import properties as port
from repro_torch.core.gamma import gamma_matrix
from repro_torch.core.types import Allocation, AllocationProblem

SEEDS = range(30)
REL = 1e-9
#: (reference checker, port checker)
CHECKERS = (
    (ref.check_feasible_rdm, port.check_feasible_rdm_torch),
    (ref.check_feasible_tdm, port.check_feasible_tdm_torch),
    (ref.check_sharing_incentive, port.check_sharing_incentive_torch),
    (ref.check_envy_freeness, port.check_envy_freeness_torch),
    (ref.check_pareto_tdm, port.check_pareto_tdm_torch),
    (ref.check_bottleneck_structure_rdm,
     port.check_bottleneck_structure_rdm_torch),
)
_NUMBER = re.compile(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?")


def _arrays(seed, max_users=6, max_servers=4, max_resources=3):
    """The arrays ``tests/test_properties.py::problems`` draws, the sizes
    and the generator's seed taken from ``seed``."""
    rng0 = np.random.default_rng(seed)
    n = int(rng0.integers(2, max_users + 1))
    k = int(rng0.integers(1, max_servers + 1))
    r = int(rng0.integers(1, max_resources + 1))
    rng = np.random.default_rng(int(rng0.integers(0, 2**31 - 1)))
    demands = rng.uniform(0.05, 2.0, (n, r))
    mask = rng.random((n, r)) > 0.3
    demands = demands * mask
    demands[demands.sum(axis=1) == 0, 0] = 1.0
    caps = rng.uniform(1.0, 30.0, (k, r))
    zero_mask = rng.random((k, r)) < 0.15
    caps = np.where(zero_mask & (caps.sum(axis=1, keepdims=True) > caps),
                    0.0, caps)
    elig = (rng.random((n, k)) > 0.25).astype(float)
    weights = rng.uniform(0.5, 3.0, n)
    prob = AllocationProblem(demands, caps, weights, elig)
    keep = gamma_matrix(prob).sum(axis=1) > 0
    if keep.sum() < 2:
        elig = np.ones((n, k))
        caps = np.maximum(caps, 0.5)
        keep = gamma_matrix(AllocationProblem(demands, caps, weights,
                                              elig)).sum(axis=1) > 0
    return demands[keep], caps, weights[keep], elig[keep]


def _pair(arrays):
    return RefProblem(*arrays), AllocationProblem(*arrays)


def _same_verdict(ref_prob, port_prob, x, tol, what):
    """Every checker of both packages on x: equal ok and detail text,
    numbers within REL. Returns the port's verdicts by checker name."""
    out = {}
    for ref_check, port_check in CHECKERS:
        want = ref_check(RefAllocation(ref_prob, x), tol=tol)
        got = port_check(Allocation(port_prob, x), tol=tol, device="cpu")
        assert bool(got[0]) == bool(want[0]), (what, port_check.__name__,
                                               got, want)
        assert _NUMBER.sub("#", got[1]) == _NUMBER.sub("#", want[1]), (
            what, port_check.__name__, got, want)
        for a, b in zip(_NUMBER.findall(got[1]), _NUMBER.findall(want[1])):
            a, b = float(a), float(b)
            assert abs(a - b) <= REL * max(abs(b), 1e-12), (
                what, port_check.__name__, got, want)
        out[port_check.__name__] = got
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_fixed_points_give_the_reference_verdicts(seed):
    rp, pp = _pair(_arrays(seed))
    for solve in (solve_psdsf_rdm, solve_psdsf_tdm):
        alloc, info = solve(rp)
        tol = max(1e-5, 10.0 * info.residual)
        got = _same_verdict(rp, pp, alloc.x, tol, (seed, solve.__name__))
        mode = "tdm" if solve is solve_psdsf_tdm else "rdm"
        for check in port.ALLOCATOR_GUARANTEES_TORCH[f"psdsf-{mode}"]:
            assert got[check.__name__].ok, (seed, check.__name__,
                                            got[check.__name__])


@pytest.mark.parametrize("seed", SEEDS)
def test_random_allocations_give_the_reference_offenders(seed):
    rp, pp = _pair(_arrays(seed))
    g = gamma_matrix(pp)
    rng = np.random.default_rng(1000 + seed)
    share = pp.weights / pp.weights.sum()
    for scale in (0.3, 1.0, 3.0):
        # near the uniform split, then perturbed: every property breaks
        # somewhere over the seeds, at various users and servers
        x = g * share[:, None] * scale * rng.uniform(0.2, 2.0, g.shape)
        _same_verdict(rp, pp, x, 1e-6, (seed, scale))


def _planted(x, g, d, caps, kind):
    """A copy of the fixed point x with one violation of ``kind``, and
    the index the port must report it at."""
    x = x.copy()
    load = x.sum(axis=0)
    i = int(np.argmax(load))
    n = int(np.argmax(x.sum(axis=1)))
    if kind == "negative":
        x[n, i] = -1.0
        return x, (n, i)
    if kind == "ineligible":
        n, i = map(int, np.argwhere(g <= 0)[0])
        x[n, i] = 1.0
        return x, (n, i)
    if kind == "capacity":
        x[:, i] *= 2.0
        usage = x.T @ d
        scale = np.maximum(caps, max(caps.max(initial=1.0) * 1e-6, 1e-12))
        return x, tuple(np.unravel_index(np.argmax((usage - caps) / scale),
                                         caps.shape))
    if kind == "uniform":
        x[n] = 0.0
        return x, (n,)
    if kind == "envied":
        m = int(np.argmin(x.sum(axis=1)))
        x[m] *= 4.0
        return x, None
    # the lowest server with eligible users: about halving its column
    # moves the users' totals, so a later server may fail too, but none
    # before it. Each user's factor is its own: a TDM fixed point gives
    # users equal normalized shares, and a common factor would leave the
    # other checkers' offenders to ties in rounding
    first = int(np.argmax((g > 0).any(axis=0)))
    jitter = 1.0 + 1e-3 * np.arange(1, x.shape[0] + 1) / x.shape[0]
    if kind == "time-share":
        x[:, first] *= 0.5 * jitter
        return x, (first,)
    if kind == "bottleneck":
        x[:, first] *= 0.5 * jitter
        return x, (int(np.argmax(g[:, first] > 0)), first)
    raise ValueError(kind)


PLANTS = {"negative": port.check_feasible_rdm_torch,
          "ineligible": port.check_feasible_rdm_torch,
          "capacity": port.check_feasible_rdm_torch,
          "uniform": port.check_sharing_incentive_torch,
          "envied": port.check_envy_freeness_torch,
          "time-share": port.check_pareto_tdm_torch,
          "bottleneck": port.check_bottleneck_structure_rdm_torch}


@pytest.mark.parametrize("kind", sorted(PLANTS))
def test_planted_violations_are_caught_where_planted(kind):
    caught = 0
    for seed in SEEDS:
        rp, pp = _pair(_arrays(seed))
        g = gamma_matrix(pp)
        if kind == "ineligible" and not (g <= 0).any():
            continue
        solve = solve_psdsf_tdm if kind == "time-share" else solve_psdsf_rdm
        alloc, _ = solve(rp)
        x, at = _planted(alloc.x, g, pp.demands, pp.capacities, kind)
        got = _same_verdict(rp, pp, x, 1e-5, (seed, kind))
        verdict = got[PLANTS[kind].__name__]
        if verdict.ok:
            # an envied user needs a user eligible where it runs
            assert kind == "envied", (seed, kind, verdict)
            continue
        caught += 1
        if at is not None:
            assert verdict.where == at, (seed, kind, verdict, verdict.where)
    assert caught >= len(SEEDS) // 3, (kind, caught)


def test_guarantee_matrix_equals_the_reference_tests():
    from test_properties import ALLOCATOR_GUARANTEES
    names = {m: tuple(c.__name__ + "_torch" for c in checks)
             for m, checks in ALLOCATOR_GUARANTEES.items()}
    assert names == {m: tuple(c.__name__ for c in checks) for m, checks in
                     port.ALLOCATOR_GUARANTEES_TORCH.items()}


@pytest.mark.parametrize("mechanism",
                         sorted(port.ALLOCATOR_GUARANTEES_TORCH))
def test_port_solves_keep_their_guarantees(mechanism):
    for seed in SEEDS[:10]:
        prob = AllocationProblem(*_arrays(seed))
        alloc, info = engine.solve(prob, mechanism, device="cpu")
        assert info.converged, (mechanism, seed, info)
        tol = max(1e-5, 10.0 * info.residual)
        for check in port.ALLOCATOR_GUARANTEES_TORCH[mechanism]:
            verdict = check(alloc, tol=tol, device="cpu")
            assert verdict.ok, (mechanism, seed, check.__name__, verdict)


def test_envy_tiles_give_the_untiled_verdict(monkeypatch):
    rp, pp = _pair(_arrays(3, max_users=40, max_servers=6))
    alloc, _ = solve_psdsf_rdm(rp)
    x = alloc.x.copy()
    x[int(np.argmin(x.sum(axis=1)))] *= 4.0
    whole = port.check_envy_freeness_torch(Allocation(pp, x), device="cpu")
    for tile in (1, 3, 7):
        monkeypatch.setattr(port, "ENVY_TILE", tile)
        part = port.check_envy_freeness_torch(Allocation(pp, x), device="cpu")
        assert part == whole and part.where == whole.where
        assert part.margin == whole.margin
    assert whole == ref.check_envy_freeness(RefAllocation(rp, x))


def test_utility_and_weighted_max_min_equal_the_reference():
    rp, pp = _pair(_arrays(5))
    rng = np.random.default_rng(5)
    for n in range(pp.num_users):
        a = rng.uniform(0.0, 3.0, pp.num_resources)
        assert port.utility_of_torch(pp, n, a, device="cpu") == \
            pytest.approx(ref.utility_of(rp, n, a), rel=REL)
    v = rng.uniform(1.0, 2.0, 8)
    w = rng.uniform(0.5, 2.0, 8)
    perm = rng.permutation(8)
    for other in (v[perm], v + 1e-3, v * (1 + 1e-6)):
        assert port.weighted_max_min_check_torch(v, w, other, device="cpu") \
            == ref.weighted_max_min_check(v, w, other)
