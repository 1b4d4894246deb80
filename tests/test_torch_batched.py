"""The port's batched and incremental solves against the JAX reference's,
on the CPU.

Reference values come from the jitted ``psdsf_solve_batched`` /
``psdsf_resolve_batched`` in float64 (``jax.enable_x64(True)``,
function-scoped) at ``tol=0`` with a fixed budget, so both packages run the
same rounds; the bound is 1e-9 per entry, and each problem's round counts
must be equal. The instances are the reference tests' own
(``tests/test_batched_solver.py``, ``tests/test_layout.py:333``,
``tests/test_accel.py:230``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AllocationProblem as JaxProblem
from repro.core import gamma_matrix as jax_gamma_matrix
from repro.core import psdsf_jax
from repro.core.instances import sparse_cell_instance
from repro_torch.core import batched
from repro_torch.core.layout import BucketedLayout
from repro_torch.core.types import AllocationProblem

from conftest import random_problems

ATOL = 1e-9


@pytest.fixture()
def x64():
    with jax.enable_x64(True):
        yield


def _port(prob):
    return AllocationProblem(prob.demands, prob.capacities, prob.weights,
                             prob.eligibility)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_rows_equal(got, want, int_cols):
    """Port and reference output tuples: x (and float columns) to 1e-9,
    the integer columns (round counts, Anderson counters) exactly."""
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        if c in int_cols:
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                       atol=ATOL)


def _ragged():
    return random_problems(6, seed=3, max_users=10, max_servers=5,
                           max_resources=4)


def _arrays(bat):
    return bat["demands"], bat["capacities"], bat["weights"], bat["gamma"]


def _padded_buckets(gammas):
    """Each problem's BucketedLayout padded to a common Bmax with masked
    slots (tests/test_layout.py:333)."""
    lays = [BucketedLayout.from_support(np.asarray(g) > 0) for g in gammas]
    bmax = max(lay.bucket_max for lay in lays)
    idx = np.stack([np.pad(lay.indices, ((0, 0), (0, bmax - lay.bucket_max)))
                    for lay in lays])
    mask = np.stack([np.pad(lay.mask, ((0, 0), (0, bmax - lay.bucket_max)))
                     for lay in lays])
    return idx, mask


def _sparse_pair():
    return [sparse_cell_instance(num_users=200, num_servers=32, density=0.08,
                                 cells=4, seed=s)[0] for s in (2, 3)]


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss")])
def test_solve_batched_matches_jax_f64(x64, mode, fill, round):
    probs = _ragged()
    kw = dict(mode=mode, max_rounds=16, tol=0.0, fill=fill, round=round)
    want = psdsf_jax.psdsf_solve_batched(
        *_arrays(psdsf_jax.batch_problems(probs, dtype=np.float64)), **kw)
    bat = batched.batch_problems([_port(p) for p in probs], dtype=np.float64,
                                 device="cpu")
    got = batched.psdsf_solve_batched(*_arrays(bat), device="cpu", **kw)
    _assert_rows_equal(got, want, int_cols=(1,))
    assert got[0].dtype == torch.float64


@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss")])
def test_solve_batched_bucketed_matches_jax_f64(x64, fill, round):
    probs = _sparse_pair()
    ref_bat = psdsf_jax.batch_problems(probs, dtype=np.float64)
    idx, mask = _padded_buckets(ref_bat["gamma"])
    kw = dict(max_rounds=12, tol=0.0, fill=fill, round=round,
              layout="bucketed")
    want = psdsf_jax.psdsf_solve_batched(
        *_arrays(ref_bat), buckets=(jnp.asarray(idx), jnp.asarray(mask)),
        **kw)
    bat = batched.batch_problems([_port(p) for p in probs], dtype=np.float64,
                                 device="cpu")
    got = batched.psdsf_solve_batched(*_arrays(bat), buckets=(idx, mask),
                                      device="cpu", **kw)
    _assert_rows_equal(got, want, int_cols=(1,))


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss")])
def test_resolve_batched_matches_jax_f64(x64, layout, fill, round):
    # tests/test_layout.py:333: a restricted sweep over servers 0..7 of two
    # sparse instances, then the full verification sweeps
    probs = _sparse_pair()
    ref_bat = psdsf_jax.batch_problems(probs, dtype=np.float64)
    srv = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    x0 = np.zeros(ref_bat["gamma"].shape)
    kw = dict(max_rounds=6, tol=0.0, fill=fill, round=round, layout=layout)
    buckets = _padded_buckets(ref_bat["gamma"]) if layout == "bucketed" \
        else None
    want = psdsf_jax.psdsf_resolve_batched(
        *_arrays(ref_bat), jnp.asarray(x0), jnp.asarray(srv),
        buckets=None if buckets is None else tuple(jnp.asarray(b)
                                                   for b in buckets), **kw)
    bat = batched.batch_problems([_port(p) for p in probs], dtype=np.float64,
                                 device="cpu")
    got = batched.psdsf_resolve_batched(*_arrays(bat), x0, srv,
                                        buckets=buckets, device="cpu", **kw)
    assert len(got) == 4
    _assert_rows_equal(got, want, int_cols=(1, 2))


def _limit_cycle_instance():
    """tests/test_accel.py's 100 x 20 dense instance (limit-cycling)."""
    rng = np.random.default_rng(0)
    return JaxProblem(rng.uniform(0.05, 2.0, (100, 4)),
                      rng.uniform(5.0, 50.0, (20, 4)),
                      rng.uniform(0.5, 2.0, 100),
                      (rng.random((100, 20)) > 0.3).astype(float))


def test_resolve_batched_anderson_matches_jax_f64(x64):
    # tests/test_accel.py:230's warm restart under Anderson, at tol=0 on
    # the limit-cycling instance (P4): the 6-tuple, counters exact
    prob = _limit_cycle_instance()
    g = jax_gamma_matrix(prob)
    arrays = (prob.demands, prob.capacities, prob.weights, g)
    x_fp, *_ = psdsf_jax.psdsf_solve_jax(*map(jnp.asarray, arrays),
                                         max_rounds=40, tol=0.0,
                                         accel="anderson")
    stacked = [np.stack([a] * 2) for a in arrays]
    x0 = np.stack([np.asarray(x_fp)] * 2)
    srv = np.stack([np.arange(4, dtype=np.int32),
                    np.array([5, 6, 7, 5], dtype=np.int32)])
    kw = dict(max_rounds=12, tol=0.0, accel="anderson")
    want = psdsf_jax.psdsf_resolve_batched(
        *map(jnp.asarray, stacked), jnp.asarray(x0), jnp.asarray(srv), **kw)
    got = batched.psdsf_resolve_batched(*stacked, x0, srv, device="cpu",
                                        **kw)
    assert len(got) == len(want) == 6
    _assert_rows_equal(got, want, int_cols=(1, 2, 4, 5))
    assert int(got[4].sum() + got[5].sum()) > 0


def test_solve_batched_anderson_counters_match_jax_f64(x64):
    # the limit-cycling instance and a copy with every server degraded
    prob = _limit_cycle_instance()
    probs = [prob, JaxProblem(prob.demands, 0.7 * prob.capacities,
                              prob.weights, prob.eligibility)]
    kw = dict(max_rounds=20, tol=0.0, accel="anderson", fill="bisect",
              round="jacobi")
    want = psdsf_jax.psdsf_solve_batched(
        *_arrays(psdsf_jax.batch_problems(probs, dtype=np.float64)), **kw)
    bat = batched.batch_problems([_port(p) for p in probs], dtype=np.float64,
                                 device="cpu")
    got = batched.psdsf_solve_batched(*_arrays(bat), device="cpu", **kw)
    _assert_rows_equal(got, want, int_cols=(1, 3, 4))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batch_problems_and_unbatch_match_jax(x64, dtype):
    probs = _ragged()
    want = psdsf_jax.batch_problems(probs, dtype=dtype)
    got = batched.batch_problems([_port(p) for p in probs], dtype=dtype,
                                 device="cpu")
    assert got["sizes"] == want["sizes"]
    for key in ("demands", "capacities", "weights", "gamma"):
        assert _np(got[key]).dtype == np.dtype(dtype)
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))
    x = np.random.default_rng(0).random(np.asarray(want["gamma"]).shape)
    ref_allocs = psdsf_jax.unbatch_solutions(jnp.asarray(x), probs)
    for src in (x, torch.as_tensor(x)):
        allocs = batched.unbatch_solutions(src, [_port(p) for p in probs])
        for a, r in zip(allocs, ref_allocs):
            np.testing.assert_array_equal(a.x, r.x)


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
def test_padding_is_inert(mode):
    # tests/test_batched_solver.py:70: a ragged batch leaves padded users
    # and servers at exact zeros, and each problem equals its solve alone
    probs = [_port(p) for p in random_problems(4, seed=11, max_users=12,
                                               max_servers=6)]
    bat = batched.batch_problems(probs, device="cpu")
    kw = dict(mode=mode, max_rounds=40, fill="bisect", round="jacobi",
              device="cpu")
    xb, rounds, _ = batched.psdsf_solve_batched(*_arrays(bat), **kw)
    for j, prob in enumerate(probs):
        n, k = prob.num_users, prob.num_servers
        pad = _np(xb[j])
        assert np.all(pad[n:, :] == 0) and np.all(pad[:, k:] == 0)
        one = batched.batch_problems([prob], device="cpu")
        x1, r1, _ = batched.psdsf_solve_batched(*_arrays(one), **kw)
        assert int(r1[0]) == int(rounds[j])
        np.testing.assert_allclose(pad[:n, :k], _np(x1[0]), rtol=0,
                                   atol=1e-6)


def test_batched_validation():
    probs = [_port(p) for p in _ragged()[:2]]
    args = _arrays(batched.batch_problems(probs, device="cpu"))
    x0 = np.zeros(tuple(args[3].shape))
    srv = np.zeros((2, 1), dtype=np.int32)
    for fn, extra in ((batched.psdsf_solve_batched, ()),
                      (batched.psdsf_resolve_batched, (x0, srv))):
        # headroom runs (its parity cases are below)
        out = fn(*args, *extra, placement="headroom", device="cpu")
        assert out[0].shape == args[3].shape
        for kw in (dict(placement="bestfit"), dict(placement="nope"),
                   dict(fill="sorted"), dict(round="red"), dict(mode="xdm"),
                   dict(accel="newton"), dict(layout="auto"),
                   dict(layout="bucketed")):
            with pytest.raises(ValueError):
                fn(*args, *extra, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("layout", ["dense", "bucketed"])
def test_solve_batched_headroom_matches_jax_f64(x64, layout, mode):
    # the level solve (on either layout), then each problem's dense
    # repack-and-refill passes
    probs = _sparse_pair()
    ref_bat = psdsf_jax.batch_problems(probs, dtype=np.float64)
    kw = dict(mode=mode, max_rounds=12, tol=0.0, fill="bisect",
              round="jacobi", layout=layout, placement="headroom")
    buckets = _padded_buckets(ref_bat["gamma"]) if layout == "bucketed" \
        else None
    want = psdsf_jax.psdsf_solve_batched(
        *_arrays(ref_bat), buckets=None if buckets is None
        else tuple(jnp.asarray(b) for b in buckets), **kw)
    bat = batched.batch_problems([_port(p) for p in probs], dtype=np.float64,
                                 device="cpu")
    got = batched.psdsf_solve_batched(*_arrays(bat), buckets=buckets,
                                      device="cpu", **kw)
    _assert_rows_equal(got, want, int_cols=(1,))
    level = batched.psdsf_solve_batched(
        *_arrays(bat), buckets=buckets, device="cpu",
        **dict(kw, placement="level"))
    assert float((got[0] - level[0]).abs().max()) > 1e-6   # a pass was kept


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
def test_resolve_batched_headroom_matches_jax_f64(x64, layout):
    probs = _sparse_pair()
    ref_bat = psdsf_jax.batch_problems(probs, dtype=np.float64)
    srv = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    x0 = np.zeros(ref_bat["gamma"].shape)
    kw = dict(max_rounds=6, tol=0.0, fill="bisect", round="jacobi",
              layout=layout, placement="headroom")
    buckets = _padded_buckets(ref_bat["gamma"]) if layout == "bucketed" \
        else None
    want = psdsf_jax.psdsf_resolve_batched(
        *_arrays(ref_bat), jnp.asarray(x0), jnp.asarray(srv),
        buckets=None if buckets is None else tuple(jnp.asarray(b)
                                                   for b in buckets), **kw)
    bat = batched.batch_problems([_port(p) for p in probs], dtype=np.float64,
                                 device="cpu")
    got = batched.psdsf_resolve_batched(*_arrays(bat), x0, srv,
                                        buckets=buckets, device="cpu", **kw)
    _assert_rows_equal(got, want, int_cols=(1, 2))


def test_solve_batched_headroom_anderson_matches_jax_f64(x64):
    # Anderson counters are the level solve's; the refills run plain
    prob = _limit_cycle_instance()
    probs = [prob, JaxProblem(prob.demands, 0.7 * prob.capacities,
                              prob.weights, prob.eligibility)]
    kw = dict(max_rounds=16, tol=0.0, accel="anderson", fill="bisect",
              round="jacobi", placement="headroom")
    want = psdsf_jax.psdsf_solve_batched(
        *_arrays(psdsf_jax.batch_problems(probs, dtype=np.float64)), **kw)
    bat = batched.batch_problems([_port(p) for p in probs], dtype=np.float64,
                                 device="cpu")
    got = batched.psdsf_solve_batched(*_arrays(bat), device="cpu", **kw)
    assert len(got) == len(want) == 5
    _assert_rows_equal(got, want, int_cols=(1, 3, 4))
