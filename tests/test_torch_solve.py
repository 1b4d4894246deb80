"""The port's dense PS-DSF solve against the JAX reference, on the CPU.

Reference values come from the jitted ``psdsf_solve_jax`` in float64
(``jax.enable_x64(True)``, function-scoped) at ``tol=0`` with a fixed
``max_rounds``, so both packages run the same rounds; the bound is 1e-9 per
entry. The Jacobi bisect round goes through ``kernels/psdsf_fill``'s plain
version here (CPU tensors), the Gauss-Seidel fills are plain torch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as jax_engine
from repro.core import gamma_matrix as jax_gamma_matrix
from repro.core import instances as jax_instances
from repro.core.psdsf_jax import psdsf_solve_jax
from repro_torch.core import engine, instances
from repro_torch.core.gamma import gamma_matrix, gamma_matrix_torch
from repro_torch.core.psdsf_torch import (psdsf_solve_torch,
                                          solve_psdsf_rdm_torch,
                                          solve_psdsf_tdm_torch)
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


def _jax_solve(prob, **kw):
    g = jax_gamma_matrix(prob)
    x, rounds, resid = psdsf_solve_jax(
        jnp.asarray(prob.demands), jnp.asarray(prob.capacities),
        jnp.asarray(prob.weights), jnp.asarray(g), **kw)
    return np.asarray(x), int(rounds), float(resid)


def _torch_solve(prob, **kw):
    x, rounds, resid = psdsf_solve_torch(
        prob.demands, prob.capacities, prob.weights, jax_gamma_matrix(prob),
        device="cpu", **kw)
    return x.numpy(), rounds, float(resid)


_JACOBI = [("fig1", jax_instances.fig1_instance),
           ("fig2", jax_instances.fig2_instance),
           ("cell64x8", lambda: jax_instances.cell_cluster_instance(
               64, 8, cells=4)[0])]


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("name,prob_fn", _JACOBI, ids=[c[0] for c in _JACOBI])
def test_jacobi_bisect_matches_jax_f64(x64, name, prob_fn, mode):
    prob = prob_fn()
    kw = dict(mode=mode, max_rounds=24, tol=0.0, fill="bisect",
              round="jacobi")
    xj, rj, resj = _jax_solve(prob, **kw)
    xt, rt, rest = _torch_solve(prob, **kw)
    assert xt.dtype == np.float64
    assert rt == rj == 24
    np.testing.assert_allclose(xt, xj, rtol=0, atol=ATOL)
    assert abs(rest - resj) <= ATOL


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("fill", ["event", "bisect"])
@pytest.mark.parametrize("idx", range(4))
def test_gauss_matches_jax_on_random_problems_f64(x64, idx, fill, mode):
    prob = random_problems(4, seed=3)[idx]
    kw = dict(mode=mode, max_rounds=24, tol=0.0, fill=fill, round="gauss")
    xj, _, _ = _jax_solve(prob, **kw)
    xt, _, _ = _torch_solve(prob, **kw)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fill,round", [("event", "jacobi"),
                                        ("event", "gauss"),
                                        ("bisect", "gauss")])
def test_other_rounds_match_jax_on_cell_f64(x64, fill, round):
    prob = jax_instances.cell_cluster_instance(64, 8, cells=4)[0]
    kw = dict(mode="rdm", max_rounds=12, tol=0.0, fill=fill, round=round)
    xj, rj, _ = _jax_solve(prob, **kw)
    xt, rt, _ = _torch_solve(prob, **kw)
    assert rt == rj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=ATOL)


_PAPER = {"fig1": ([3.0, 3.0, 6.0], instances.fig1_instance),
          "fig2": ([3.6, 3.6, 8.0, 8.0], instances.fig2_instance)}


@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss"),
                                        ("bisect", "gauss"),
                                        ("event", "jacobi")])
@pytest.mark.parametrize("name", sorted(_PAPER))
def test_paper_values_through_engine(name, fill, round):
    want, prob_fn = _PAPER[name]
    alloc, info = engine.solve(prob_fn(), "psdsf-rdm", device="cpu",
                               fill=fill, round=round, tol=1e-9,
                               max_rounds=512)
    assert info.converged and not info.approx
    np.testing.assert_allclose(alloc.tasks_per_user, want, atol=1e-6)


@pytest.mark.parametrize("name", sorted(_PAPER))
def test_tdm_matches_reference_numpy_solver(name):
    from repro.core import solve_psdsf_tdm
    ref_prob = getattr(jax_instances, f"{name}_instance")()
    want = solve_psdsf_tdm(ref_prob)[0].tasks_per_user
    alloc, _ = engine.solve(_PAPER[name][1](), "psdsf-tdm", device="cpu",
                            fill="bisect", round="jacobi", tol=1e-10,
                            max_rounds=512)
    np.testing.assert_allclose(alloc.tasks_per_user, want, atol=1e-6)


def test_convenience_wrappers():
    prob = instances.fig1_instance()
    for fn in (solve_psdsf_rdm_torch, solve_psdsf_tdm_torch):
        alloc = fn(prob, max_rounds=64, device="cpu")
        np.testing.assert_allclose(alloc.tasks_per_user, [3.0, 3.0, 6.0],
                                   atol=1e-6)


@pytest.mark.parametrize("fill,round,mode", [("bisect", "jacobi", "rdm"),
                                             ("bisect", "jacobi", "tdm"),
                                             ("event", "gauss", "rdm")])
def test_warm_start_from_jax_fixed_point(x64, fill, round, mode):
    prob = jax_instances.fig2_instance()
    x_star, _, _ = _jax_solve(prob, mode=mode, max_rounds=2000, tol=1e-13,
                              fill=fill, round=round)
    xt, rounds, _ = _torch_solve(prob, x0=x_star, mode=mode, max_rounds=8,
                                 tol=1e-12, fill=fill, round=round)
    assert rounds <= 8
    np.testing.assert_allclose(xt, x_star, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mechanism", ["psdsf-rdm", "psdsf-tdm"])
@pytest.mark.parametrize("name,prob_fn,tol", [
    ("fig2", jax_instances.fig2_instance, 1e-6),
    ("cell64x8", lambda: jax_instances.cell_cluster_instance(
        64, 8, cells=4)[0], 0.0)])
def test_solveinfo_matches_reference_engine(x64, mechanism, name, prob_fn,
                                            tol):
    prob = prob_fn()
    kw = dict(fill="bisect", round="jacobi", layout="dense", tol=tol,
              max_rounds=40)
    a_ref, i_ref = jax_engine.solve(prob, mechanism, backend="jax", **kw)
    a, info = engine.solve(_port(prob), mechanism, device="cpu", **kw)
    for field in ("rounds", "converged", "approx", "fill_iters",
                  "fill_engine", "layout", "bucket_max", "placement",
                  "accel", "accel_hits", "accel_rejects", "rounds_to_tol",
                  "lp_calls", "servers_skipped"):
        assert getattr(info, field) == getattr(i_ref, field), field
    assert info.stranded_frac == pytest.approx(i_ref.stranded_frac,
                                               abs=1e-9)
    assert abs(info.residual - i_ref.residual) <= ATOL
    np.testing.assert_allclose(a.x, a_ref.x, rtol=0, atol=ATOL)


def test_lexmm_is_the_level_solve():
    prob = instances.fig2_instance()
    a_level, _ = engine.solve(prob, device="cpu", max_rounds=64)
    a_lexmm, info = engine.solve(prob, device="cpu", max_rounds=64,
                                 placement="lexmm")
    assert info.placement == "lexmm"
    np.testing.assert_array_equal(a_level.x, a_lexmm.x)


@pytest.mark.parametrize("kw", [dict(mechanism="nope"),
                                dict(backend="jax"),
                                dict(fill="sorted"), dict(round="red"),
                                dict(placement="nope"),
                                dict(placement="bestfit"),
                                dict(layout="sparse"), dict(accel="newton")])
def test_rejected_values_raise_value_error(kw):
    with pytest.raises(ValueError):
        engine.solve(instances.fig1_instance(), device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(mechanism="tsf", placement="lexmm"),
                                dict(mechanism="cdrf", placement="lexmm"),
                                dict(mechanism="cdrfh", placement="lexmm"),
                                dict(backend="numpy"),
                                dict(mechanism="drf", backend="numpy")])
def test_unported_values_raise_not_implemented(kw):
    # what still raises: the numpy backend (the baselines, drf, uniform,
    # headroom and, since the host router is ported, the baselines' lexmm
    # run: see tests/test_torch_baselines.py, tests/test_torch_placement.py
    # and tests/test_torch_lexmm.py)
    if kw.get("backend") == "numpy":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            engine.solve(instances.fig1_instance(), device="cpu", **kw)
        return
    alloc, info = engine.solve(instances.fig1_instance(), device="cpu",
                               **kw)
    assert info.placement == "lexmm" and info.converged
    assert alloc.x.shape == (3, 2)


def test_unknown_mode_raises():
    prob = instances.fig1_instance()
    with pytest.raises(ValueError, match="mode"):
        psdsf_solve_torch(prob.demands, prob.capacities, prob.weights,
                          gamma_matrix(prob), mode="xdm", device="cpu")


def test_float32_inputs_solve_in_float32():
    prob = instances.fig1_instance()
    x, _, resid = psdsf_solve_torch(
        prob.demands.astype(np.float32), prob.capacities.astype(np.float32),
        prob.weights.astype(np.float32),
        gamma_matrix(prob).astype(np.float32), fill="bisect", round="jacobi",
        device="cpu")
    assert x.dtype == resid.dtype == __import__("torch").float32
    np.testing.assert_allclose(x.numpy().sum(axis=1), [3, 3, 6], atol=1e-4)


_GENERATORS = [
    ("fig1", {}), ("fig2", {}),
    ("dense_random", dict(seed=3)),
    ("cell_cluster", dict(num_users=96, num_servers=16, cells=4, seed=2)),
    ("sparse_cell", dict(num_users=500, num_servers=64, cells=8,
                         multi_frac=0.5, seed=1)),
]


@pytest.mark.parametrize("name,kw", _GENERATORS, ids=[g[0] for g in _GENERATORS])
def test_instances_bit_identical(name, kw):
    got = getattr(instances, f"{name}_instance")(**kw)
    want = getattr(jax_instances, f"{name}_instance")(**kw)
    if isinstance(want, tuple):
        for g_, w_ in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g_, w_)
        got, want = got[0], want[0]
    for field in ("demands", "capacities", "weights", "eligibility"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    np.testing.assert_array_equal(gamma_matrix(got), jax_gamma_matrix(want))


def test_gamma_matrix_torch_matches_numpy():
    import torch
    prob = instances.dense_random_instance(seed=4)
    prob = AllocationProblem(np.where(prob.demands > 1.5, 0.0, prob.demands),
                             prob.capacities, prob.weights, prob.eligibility)
    got = gamma_matrix_torch(*(torch.as_tensor(a) for a in (
        prob.demands, prob.capacities, prob.eligibility)))
    np.testing.assert_allclose(got.numpy(), gamma_matrix(prob), rtol=1e-15)


def test_problem_validation_matches_reference():
    from repro.core.types import AllocationProblem as RefProblem
    bad = [dict(demands=[[1.0, -1.0]], capacities=[[1.0, 1.0]]),
           dict(demands=[[0.0, 0.0]], capacities=[[1.0, 1.0]]),
           dict(demands=[[1.0, 1.0]], capacities=[[1.0]]),
           dict(demands=[[1.0]], capacities=[[1.0]], weights=[0.0]),
           dict(demands=[[1.0]], capacities=[[1.0]], eligibility=[[0.5]])]
    for kw in bad:
        with pytest.raises(ValueError):
            RefProblem(**kw)
        with pytest.raises(ValueError):
            AllocationProblem(**kw)


@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss"),
                                        ("event", "jacobi")])
def test_restricted_sweep_matches_jax_core(x64, fill, round):
    # the servers= restriction and alpha0 of the reference's _solve_core,
    # from a warm start: only the listed servers move
    import torch
    from repro.core.psdsf_jax import _solve_core
    from repro_torch.core.psdsf_torch import _solve_core_torch
    prob = jax_instances.cell_cluster_instance(64, 8, cells=4)[0]
    g = jax_gamma_matrix(prob)
    x0 = np.random.default_rng(1).uniform(0.0, 1.0, g.shape) * (g > 0)
    servers = np.array([1, 4, 6], dtype=np.int32)
    arrays = (prob.demands, prob.capacities, prob.weights, g, x0)
    xj, rj, _ = _solve_core(*map(jnp.asarray, arrays), "rdm", 10, 0.0,
                            servers=jnp.asarray(servers), alpha0=0.3,
                            fill=fill, round_mode=round)
    xt, rt, _ = _solve_core_torch(*map(torch.as_tensor, arrays), "rdm", 10,
                                  0.0, servers=servers, alpha0=0.3,
                                  fill=fill, round_mode=round)
    assert rt == int(rj) == 10
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=ATOL)
    untouched = np.setdiff1d(np.arange(g.shape[1]), servers)
    np.testing.assert_array_equal(xt.numpy()[:, untouched], x0[:, untouched])
