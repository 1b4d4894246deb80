"""The port's baselines (``core/baselines_torch.py`` and the five
mechanisms of ``engine.solve``) against the JAX reference on the CPU.

Reference values come from the jitted ``baselines_jax`` in float64
(``jax.enable_x64(True)``, function-scoped) at ``tol=0`` with a fixed
``max_rounds``, so both packages run the same rounds; the bound is 1e-9 per
entry, round (and routed-fill event) counts and every ``SolveInfo`` field
are equal, and the paper's Fig. 1 values hold to 1e-6. The host copies
(level rates, DRF on the pooled cluster, the uniform split) are the
reference's bit for bit. The google cluster instance (120 identical
servers) is compared under Gauss-Seidel and the routed fill: its Jacobi
sweep amplifies an ulp by ~30x a round in both packages, so its per-server
split is not comparable there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_baselines
from repro.core import baselines_jax
from repro.core import engine as jax_engine
from repro.core import instances as jax_instances
from repro.core import psdsf_jax
from repro.core.layout import BucketedLayout as JaxBucketedLayout
from repro_torch.core import baselines_torch, engine
from repro_torch.core.batched import batch_problems
from repro_torch.core.types import AllocationProblem

from conftest import random_problems

ATOL = 1e-9
PAPER_ATOL = 1e-6
MECHANISMS = ("cdrfh", "tsf", "cdrf")


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
    "google": lambda: jax_instances.google_cluster_instance()[0],
}


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def _arrays(prob, mechanism):
    lg = jax_baselines.level_rate_matrix(prob, mechanism)
    return prob.demands, prob.capacities, prob.weights, lg


def _info_equal(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    for key in a:
        if key in ("residual", "stranded_frac"):
            assert abs(a[key] - b[key]) <= ATOL, key
        else:
            assert a[key] == b[key], (key, a[key], b[key])


@pytest.mark.parametrize("mechanism", MECHANISMS)
@pytest.mark.parametrize("name", sorted(_INSTANCES))
def test_level_rates_match_reference(x64, name, mechanism):
    prob = _INSTANCES[name]()
    want = jax_baselines.level_rate_matrix(prob, mechanism)
    np.testing.assert_array_equal(
        baselines_torch.level_rate_matrix_np(_port(prob), mechanism), want)
    np.testing.assert_array_equal(
        baselines_torch.score_weights_np(_port(prob), mechanism),
        jax_baselines.score_weights(prob, mechanism))
    args = (prob.demands, prob.capacities, prob.eligibility)
    jnp_lg = baselines_jax.level_rate_matrix_jnp(
        *(jnp.asarray(a) for a in args), mechanism)
    got = baselines_torch.level_rate_matrix_torch(*(_t(a) for a in args),
                                                  mechanism)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp_lg), rtol=1e-12,
                               atol=0)
    scale = baselines_torch._gamma_scale_torch(_t(prob.demands),
                                               _t(prob.capacities), got)
    want_scale = baselines_jax._gamma_scale(
        jnp.asarray(prob.demands), jnp.asarray(prob.capacities), jnp_lg)
    assert abs(float(scale) - float(want_scale)) <= 1e-12


def test_unknown_level_fill_mechanism_raises():
    prob = _port(jax_instances.fig1_instance())
    for fn in (lambda: baselines_torch.level_rate_matrix_np(prob, "drf"),
               lambda: baselines_torch.level_rate_matrix_torch(
                   _t(prob.demands), _t(prob.capacities),
                   _t(prob.eligibility), "nope")):
        with pytest.raises(ValueError, match="level-fill mechanism"):
            fn()


@pytest.mark.parametrize("mechanism", MECHANISMS)
@pytest.mark.parametrize("name", sorted(_INSTANCES))
def test_routed_fill_core_matches_reference(x64, name, mechanism):
    arrays = _arrays(_INSTANCES[name](), mechanism)
    xj, ej, rj = baselines_jax._routed_fill_core(
        *(jnp.asarray(a) for a in arrays))
    xt, et, rt = baselines_torch._routed_fill_core_torch(
        *(_t(a) for a in arrays))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=ATOL)
    assert et == int(ej) and float(rt) == float(rj) == 0.0


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss")])
@pytest.mark.parametrize("mechanism", MECHANISMS)
@pytest.mark.parametrize("name", ["fig2", "dense24x6", "cell96x16"])
def test_baseline_solve_matches_reference(x64, name, mechanism, fill, round,
                                          layout):
    arrays = _arrays(_INSTANCES[name](), mechanism)
    buckets = None
    if layout == "bucketed":
        lay = JaxBucketedLayout.from_support(arrays[3] > 0)
        buckets = (lay.indices, lay.mask)
    kw = dict(max_rounds=24, tol=0.0, fill=fill, round=round, layout=layout)
    xj, rj, resj = baselines_jax.baseline_solve_jax(
        *(jnp.asarray(a) for a in arrays), **kw,
        buckets=None if buckets is None else tuple(map(jnp.asarray,
                                                       buckets)))
    xt, rt, rest = baselines_torch.baseline_solve_torch(
        *arrays, **kw, buckets=buckets, device="cpu")
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=ATOL)
    assert rt == int(rj)
    assert abs(float(rest) - float(resj)) <= ATOL


@pytest.mark.parametrize("placement,fill,round,layout,accel", [
    ("level", "bisect", "jacobi", "dense", "none"),
    ("level", "bisect", "jacobi", "bucketed", "none"),
    ("level", "event", "gauss", "auto", "none"),
    ("level", "bisect", "jacobi", "dense", "anderson"),
    ("headroom", "bisect", "jacobi", "auto", "none"),
    ("headroom", "event", "gauss", "dense", "anderson")])
@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_engine_baselines_match_reference(x64, mechanism, placement, fill,
                                          round, layout, accel):
    # cell 96 x 16 limit-cycles: Anderson at tol=0 is comparable (P4)
    prob = _INSTANCES["cell96x16"]()
    kw = dict(placement=placement, max_rounds=24, tol=0.0, fill=fill,
              round=round, layout=layout, accel=accel)
    a_j, i_j = jax_engine.solve(prob, mechanism, backend="jax", **kw)
    a_t, i_t = engine.solve(_port(prob), mechanism, device="cpu", **kw)
    np.testing.assert_allclose(a_t.x, a_j.x, rtol=0, atol=ATOL)
    _info_equal(i_t, i_j)


@pytest.mark.parametrize("placement", ["level", "headroom"])
@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_engine_baselines_on_google_match_reference(x64, mechanism,
                                                    placement):
    prob = _INSTANCES["google"]()
    kw = dict(placement=placement, max_rounds=3, tol=0.0, layout="dense")
    a_j, i_j = jax_engine.solve(prob, mechanism, backend="jax", **kw)
    a_t, i_t = engine.solve(_port(prob), mechanism, device="cpu", **kw)
    np.testing.assert_allclose(a_t.x, a_j.x, rtol=0, atol=ATOL)
    _info_equal(i_t, i_j)


@pytest.mark.parametrize("mechanism,want", [
    ("tsf", [2.0, 2.0, 8.0]), ("cdrf", [2.0, 2.0, 8.0]),
    ("cdrfh", [60 / 23, 72 / 23, 144 / 23])])
def test_fig1_paper_values(x64, mechanism, want):
    prob = jax_instances.fig1_instance()
    for kw in (dict(), dict(fill="bisect", round="jacobi", layout="dense",
                            max_rounds=512)):
        a_j, _ = jax_engine.solve(prob, mechanism, backend="jax", tol=1e-10,
                                  **kw)
        alloc, info = engine.solve(_port(prob), mechanism, device="cpu",
                                   tol=1e-10, **kw)
        np.testing.assert_allclose(alloc.tasks_per_user, want,
                                   atol=PAPER_ATOL)
        np.testing.assert_allclose(alloc.x, a_j.x, atol=PAPER_ATOL)
        assert info.converged


@pytest.mark.parametrize("mechanism", ["drf", "uniform"])
@pytest.mark.parametrize("name", sorted(_INSTANCES))
def test_closed_forms_match_reference(name, mechanism):
    prob = _INSTANCES[name]()
    a_j, i_j = jax_engine.solve(prob, mechanism, backend="jax")
    a_t, i_t = engine.solve(_port(prob), mechanism, device="cpu")
    np.testing.assert_array_equal(a_t.x, a_j.x)
    np.testing.assert_array_equal(a_t.problem.capacities,
                                  a_j.problem.capacities)
    assert dataclasses.asdict(i_t) == dataclasses.asdict(i_j)


def test_drf_pool_totals_match_reference_on_random_problems():
    for prob in random_problems(8, seed=4):
        np.testing.assert_array_equal(
            baselines_torch.drf_pool_totals(_port(prob)),
            jax_baselines.solve_drf_single_pool(prob))


@pytest.mark.parametrize("kw", [
    dict(placement="headroom"), dict(placement="bestfit"),
    dict(placement="lexmm"), dict(placement="nope"), dict(fill="bisect"),
    dict(round="jacobi"), dict(layout="bucketed"), dict(layout="sparse"),
    dict(accel="anderson"), dict(accel="newton")])
@pytest.mark.parametrize("mechanism", ["drf", "uniform"])
def test_closed_forms_reject_like_reference(mechanism, kw):
    prob = jax_instances.fig2_instance()
    with pytest.raises(Exception) as want:
        jax_engine.solve(prob, mechanism, backend="jax", **kw)
    with pytest.raises(type(want.value)):
        engine.solve(_port(prob), mechanism, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(placement="bestfit"), dict(placement="nope"),
    dict(placement="headroom", layout="bucketed"),
    dict(placement="lexmm", layout="bucketed"), dict(accel="newton"),
    dict(fill="sorted"), dict(round="red"), dict(layout="sparse")])
@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_baselines_reject_like_reference(mechanism, kw):
    prob = jax_instances.fig2_instance()
    with pytest.raises(Exception) as want:
        jax_engine.solve(prob, mechanism, backend="jax", **kw)
    with pytest.raises(type(want.value)):
        engine.solve(_port(prob), mechanism, device="cpu", **kw)


def test_unknown_mechanism_is_a_key_error():
    prob = jax_instances.fig1_instance()
    with pytest.raises(KeyError):
        jax_engine.solve(prob, "nope", backend="jax")
    with pytest.raises(KeyError) as err:
        engine.solve(_port(prob), "nope", device="cpu")
    assert isinstance(err.value, ValueError)
    assert str(err.value).startswith("unknown allocator 'nope'")


@pytest.mark.parametrize("placement", ["lexmm", "bestfit"])
def test_traced_entries_reject_lexmm_and_bestfit(x64, placement):
    arrays = _arrays(jax_instances.fig2_instance(), "tsf")
    with pytest.raises(ValueError):
        baselines_jax.baseline_solve_jax(*(jnp.asarray(a) for a in arrays),
                                         placement=placement)
    stacked = [a[None] for a in arrays]
    for fn, args in ((baselines_torch.baseline_solve_torch, arrays),
                     (baselines_torch.baseline_solve_batched_torch,
                      stacked)):
        with pytest.raises(ValueError):
            fn(*args, placement=placement, device="cpu")


def test_routed_fill_rejects_the_bucketed_layout(x64):
    arrays = _arrays(jax_instances.fig2_instance(), "tsf")
    lay = JaxBucketedLayout.from_support(arrays[3] > 0)
    kw = dict(placement="headroom", layout="bucketed")
    with pytest.raises(ValueError, match="bucketed"):
        baselines_jax.baseline_solve_jax(
            *(jnp.asarray(a) for a in arrays), **kw,
            buckets=(jnp.asarray(lay.indices), jnp.asarray(lay.mask)))
    with pytest.raises(ValueError, match="bucketed"):
        baselines_torch.baseline_solve_torch(
            *arrays, **kw, buckets=(lay.indices, lay.mask), device="cpu")


@pytest.mark.parametrize("placement,layout,accel", [
    ("level", "dense", "none"), ("level", "bucketed", "none"),
    ("level", "dense", "anderson"), ("headroom", "dense", "none"),
    ("headroom", "dense", "anderson")])
@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_batched_baselines_match_reference(x64, mechanism, placement, layout,
                                           accel):
    probs = random_problems(4, seed=6, max_users=10, max_servers=5,
                            max_resources=3)
    bj = psdsf_jax.batch_problems(probs, dtype=np.float64)
    lgj = baselines_jax.batch_level_rates(probs, mechanism, dtype=np.float64)
    bt = batch_problems([_port(p) for p in probs], dtype=np.float64,
                        device="cpu")
    lgt = baselines_torch.batch_level_rates_torch(
        [_port(p) for p in probs], mechanism, dtype=np.float64, device="cpu")
    np.testing.assert_array_equal(lgt.numpy(), np.asarray(lgj))
    buckets = None
    if layout == "bucketed":
        lays = [JaxBucketedLayout.from_support(np.asarray(g) > 0)
                for g in lgj]
        bmax = max(lay.bucket_max for lay in lays)
        buckets = tuple(np.stack([
            np.pad(getattr(lay, f), ((0, 0), (0, bmax - lay.bucket_max)))
            for lay in lays]) for f in ("indices", "mask"))
    # these small problems reach exact fixed points: Anderson is compared
    # at tol=1e-10, where both packages stop on the same round (P4)
    kw = dict(max_rounds=16, tol=1e-10 if accel == "anderson" else 0.0,
              placement=placement, fill="bisect", round="jacobi",
              layout=layout, accel=accel)
    want = baselines_jax.baseline_solve_batched(
        bj["demands"], bj["capacities"], bj["weights"], lgj, **kw,
        buckets=None if buckets is None else tuple(map(jnp.asarray,
                                                       buckets)))
    got = baselines_torch.baseline_solve_batched_torch(
        bt["demands"], bt["capacities"], bt["weights"], lgt, **kw,
        buckets=buckets, device="cpu")
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=ATOL)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # each problem's row is its own unbatched solve
    for j, prob in enumerate(probs):
        if layout == "bucketed":
            continue
        n, k = prob.num_users, prob.num_servers
        x1 = baselines_torch.baseline_solve_torch(
            *_arrays(prob, mechanism), **kw, device="cpu")[0]
        np.testing.assert_allclose(got[0][j, :n, :k].numpy(), x1.numpy(),
                                   rtol=0, atol=ATOL)


def test_float32_inputs_solve_in_float32():
    prob = jax_instances.fig1_instance()
    arrays = [a.astype(np.float32) for a in _arrays(prob, "tsf")]
    for placement in ("level", "headroom"):
        x, _, resid = baselines_torch.baseline_solve_torch(
            *arrays, placement=placement, device="cpu")
        assert x.dtype == resid.dtype == torch.float32
