"""The port's placement mirrors (``core/placement_torch.py``) and
``placement="headroom"`` on ``psdsf_solve_torch`` and ``engine.solve``,
against the JAX reference on the CPU.

Reference values come from the jitted reference in float64
(``jax.enable_x64(True)``, function-scoped): ``psdsf_jax``'s
``stranded_fraction_jnp``, ``_repack_core``, ``_repack_refill_core`` and
``psdsf_solve_jax(placement="headroom")``, at ``tol=0`` with a fixed
``max_rounds`` so both packages run the same rounds. The bound is 1e-9 per
entry (the paper examples 1e-6); round counts and every ``SolveInfo``
field are equal. The tick layer's host repack is the reference's
``placement.repack_pass`` bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core import gamma_matrix as jax_gamma_matrix
from repro.core import instances as jax_instances
from repro.core import placement as jax_placement
from repro.core import psdsf_jax
from repro_torch.core import engine, placement_torch
from repro_torch.core.psdsf_torch import psdsf_solve_torch
from repro_torch.core.types import AllocationProblem

ATOL = 1e-9
PAPER_ATOL = 1e-6


@pytest.fixture()
def x64():
    with jax.enable_x64(True):
        yield


def _port(prob):
    return AllocationProblem(prob.demands, prob.capacities, prob.weights,
                             prob.eligibility)


_INSTANCES = {
    "fig1": jax_instances.fig1_instance,
    "fig2": jax_instances.fig2_instance,
    "dense24x6": lambda: jax_instances.dense_random_instance(24, 6),
    "cell96x16": lambda: jax_instances.cell_cluster_instance(
        96, 16, cells=4)[0],
}


def _arrays(prob):
    return prob.demands, prob.capacities, prob.weights, jax_gamma_matrix(prob)


def _level_fixed_point(prob, mode):
    """The reference's level solve (40 Jacobi bisect rounds at tol=0)."""
    x, rounds, resid = psdsf_jax.psdsf_solve_jax(
        *(jnp.asarray(a) for a in _arrays(prob)), mode=mode, max_rounds=40,
        tol=0.0, fill="bisect", round="jacobi")
    return np.asarray(x), int(rounds), float(resid)


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


@pytest.mark.parametrize("name", sorted(_INSTANCES))
def test_stranded_fraction_matches_reference(x64, name):
    prob = _INSTANCES[name]()
    d, c, _, g = _arrays(prob)
    rng = np.random.default_rng(5)
    for x in (np.zeros(g.shape), rng.uniform(0, 1, g.shape) * (g > 0),
              _level_fixed_point(prob, "rdm")[0]):
        want = float(psdsf_jax.stranded_fraction_jnp(
            jnp.asarray(d), jnp.asarray(c), jnp.asarray(g), jnp.asarray(x)))
        got = float(placement_torch.stranded_fraction_torch(
            _t(d), _t(c), _t(g), _t(x)))
        assert abs(got - want) <= 1e-12
        assert abs(got - jax_placement.stranded_fraction(prob, x)) <= 1e-12


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("name", sorted(_INSTANCES))
def test_repack_core_matches_reference(x64, name, mode):
    prob = _INSTANCES[name]()
    d, c, w, g = _arrays(prob)
    x, _, _ = _level_fixed_point(prob, mode)
    want = np.asarray(psdsf_jax._repack_core(
        *(jnp.asarray(a) for a in (x, d, c, w, g)), mode))
    got = placement_torch._repack_core_torch(
        *(_t(a) for a in (x, d, c, w, g)), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the repack moves tasks and keeps every user's total
    np.testing.assert_allclose(got.sum(axis=1), x.sum(axis=1), rtol=0,
                               atol=ATOL)


def test_repack_core_keeps_zero_users_and_order():
    # a user with total 0 is left where it is; ties in the totals keep
    # the index order (stable), as the reference's stable argsort does
    prob = jax_instances.fig1_instance()
    d, c, w, g = _arrays(prob)
    x = np.array([[1.0, 0.0], [0.0, 0.0], [0.0, 1.0]])
    with jax.enable_x64(True):
        want = np.asarray(psdsf_jax._repack_core(
            *(jnp.asarray(a) for a in (x, d, c, w, g)), "rdm"))
    got = placement_torch._repack_core_torch(
        *(_t(a) for a in (x, d, c, w, g)), "rdm").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not got[1].any()


@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss")])
@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("name", ["dense24x6", "cell96x16"])
def test_repack_refill_core_matches_reference(x64, name, mode, fill, round):
    prob = _INSTANCES[name]()
    d, c, w, g = _arrays(prob)
    x, rounds, resid = _level_fixed_point(prob, mode)
    kw = dict(fill=fill, round_mode=round)
    xj, rj, resj = psdsf_jax._repack_refill_core(
        *(jnp.asarray(a) for a in (d, c, w, g, x)), rounds, resid, mode, 24,
        0.0, **kw)
    xt, rt, rest = placement_torch._repack_refill_core_torch(
        *(_t(a) for a in (d, c, w, g, x)), rounds, torch.tensor(resid),
        mode, 24, 0.0, **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=ATOL)
    assert int(rt) == int(rj)
    assert abs(float(rest) - float(resj)) <= ATOL


@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss"),
                                        ("bisect", "gauss")])
@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("name", sorted(_INSTANCES))
def test_psdsf_headroom_matches_reference(x64, name, mode, fill, round):
    prob = _INSTANCES[name]()
    kw = dict(mode=mode, max_rounds=40, tol=0.0, placement="headroom",
              fill=fill, round=round)
    xj, rj, resj = psdsf_jax.psdsf_solve_jax(
        *(jnp.asarray(a) for a in _arrays(prob)), **kw)
    xt, rt, rest = psdsf_solve_torch(*_arrays(prob), device="cpu", **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=ATOL)
    assert rt == int(rj)
    assert abs(float(rest) - float(resj)) <= ATOL


def test_headroom_moves_tasks_and_strands_less(x64):
    # on the dense 24 x 6 instance a repack pass is kept: the headroom
    # solve differs from the level one and strands less capacity
    prob = _INSTANCES["dense24x6"]()
    kw = dict(max_rounds=40, tol=0.0, fill="event", round="gauss",
              layout="dense")
    level, i_level = engine.solve(_port(prob), device="cpu", **kw)
    head, i_head = engine.solve(_port(prob), device="cpu",
                                placement="headroom", **kw)
    assert np.abs(head.x - level.x).max() > 0.1
    assert i_head.stranded_frac < i_level.stranded_frac - 1e-6
    assert i_head.placement == "headroom"


def _info_equal(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    for key in a:
        if key in ("residual", "stranded_frac"):
            assert abs(a[key] - b[key]) <= ATOL, key
        else:
            assert a[key] == b[key], (key, a[key], b[key])


@pytest.mark.parametrize("mechanism,layout,accel", [
    ("psdsf-rdm", "dense", "none"), ("psdsf-tdm", "dense", "none"),
    ("psdsf-rdm", "bucketed", "none"), ("psdsf-rdm", "dense", "anderson"),
    ("psdsf-tdm", "bucketed", "anderson")])
def test_engine_headroom_solveinfo_matches_reference(x64, mechanism, layout,
                                                     accel):
    # cell 96 x 16 limit-cycles, so Anderson at tol=0 is comparable (P4)
    prob = _INSTANCES["cell96x16"]()
    kw = dict(placement="headroom", max_rounds=24, tol=0.0, fill="bisect",
              round="jacobi", layout=layout, accel=accel)
    a_j, i_j = jax_engine.solve(prob, mechanism, backend="jax", **kw)
    a_t, i_t = engine.solve(_port(prob), mechanism, device="cpu", **kw)
    np.testing.assert_allclose(a_t.x, a_j.x, rtol=0, atol=ATOL)
    _info_equal(i_t, i_j)
    assert i_t.layout == layout


@pytest.mark.parametrize("name,want", [("fig1", [3.0, 3.0, 6.0]),
                                       ("fig2", [3.6, 3.6, 8.0, 8.0])])
def test_paper_examples_under_headroom(x64, name, want):
    prob = _INSTANCES[name]()
    a_j, _ = jax_engine.solve(prob, "psdsf-rdm", backend="jax",
                              placement="headroom", tol=1e-10)
    a_t, info = engine.solve(_port(prob), "psdsf-rdm", device="cpu",
                             placement="headroom", tol=1e-10)
    np.testing.assert_allclose(a_t.tasks_per_user, want, atol=PAPER_ATOL)
    np.testing.assert_allclose(a_t.x, a_j.x, atol=PAPER_ATOL)
    assert info.converged and info.placement == "headroom"


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("name", ["dense24x6", "cell96x16"])
def test_host_repack_pass_is_the_reference(name, mode, greedy):
    prob = _INSTANCES[name]()
    g = jax_gamma_matrix(prob)
    rng = np.random.default_rng(11)
    active = rng.random(prob.num_users) > 0.2
    g = np.where(active[:, None], g, 0.0)
    x = jax_placement.repack_pass(prob, rng.uniform(0, 0.3, g.shape)
                                  * (g > 0), g, mode=mode)
    want = jax_placement.repack_pass(prob, x, g, mode=mode, greedy=greedy)
    got = placement_torch.repack_pass_np(prob.demands, prob.capacities, x, g,
                                         mode=mode, greedy=greedy)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        placement_torch.headroom_matrix_np(prob.demands, prob.capacities,
                                           g > 0),
        jax_placement.headroom_matrix(prob.demands, prob.capacities, g > 0))


@pytest.mark.parametrize("kw", [dict(placement="bestfit"),
                                dict(placement="nope")])
def test_headroom_neighbours_rejected_like_reference(kw):
    prob = jax_instances.fig1_instance()
    with pytest.raises(Exception) as want:
        jax_engine.solve(prob, backend="jax", **kw)
    with pytest.raises(type(want.value)):
        engine.solve(_port(prob), device="cpu", **kw)
