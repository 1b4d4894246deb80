"""The port's host lexmm flow router (``core/flowrouter.py``) and its three
consumers (``engine.solve(..., placement="lexmm")``, the lexmm
``ChurnSimulator`` and ``DistributedPSDSF.routed_allocation``) against the
JAX reference's, on the CPU.

The router is numpy/scipy code in both packages, a copy and not a rewrite:
on one machine both run the same scipy, the same LPs in the same order, so
x agrees to 1e-12, stage counts are equal and every ``RouterStats`` field
is equal but the wall-clock ones (``solve_ms``, the values of
``stage_ms``). The consumers are held at 1e-9 (float64), their router
fields exactly; the churn telemetry (a float32 VDS reduction) at 1e-6
relative, the argmin tie-aware. ``engine.solve`` on the reference side is
``backend="jax"`` under ``jax.enable_x64(True)``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import AllocationProblem as JaxProblem
from repro.core import baselines as jax_baselines
from repro.core import dynamic as jax_dynamic
from repro.core import engine as jax_engine
from repro.core import flowrouter as jax_router
from repro.core import instances as jax_instances
from repro.sched import churn as jax_churn
from repro_torch.core import baselines_torch, dynamic, engine, flowrouter
from repro_torch.core.types import AllocationProblem
from repro_torch.sched import churn

ROUTER_ATOL = 1e-12
ATOL = 1e-9
VDS_RTOL = 1e-6
MECHANISMS = ("cdrfh", "tsf", "cdrf")
#: RouterStats fields read off the host clock, so never equal run to run
WALL_CLOCK = ("solve_ms", "stage_ms")


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
    "dense60x12": jax_instances.dense_random_instance,
    "cell48x8": lambda: jax_instances.cell_cluster_instance(
        48, 8, cells=4)[0],
}


def _level_rates(prob, mechanism):
    """Each package's own level-rate matrix (they must be equal)."""
    lg = jax_baselines.level_rate_matrix(prob, mechanism)
    lg_port = baselines_torch.level_rate_matrix_np(_port(prob), mechanism)
    np.testing.assert_array_equal(lg_port, lg)
    return lg, lg_port


def _stats_equal(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert a.keys() == b.keys()
    for key in a:
        if key in WALL_CLOCK:
            continue
        assert a[key] == b[key], (key, a[key], b[key])
    # one span a certified stage, and one a verification that failed
    assert len(got.stage_ms) == len(want.stage_ms) >= got.stages


def _pair(prob, mechanism, public=False):
    lg, lg_port = _level_rates(prob, mechanism)
    ref = jax_router.RouterState(prob, lg)
    port = flowrouter.RouterState(_port(prob), lg_port)
    # a router with no in-scope user builds no LP handle
    assert (getattr(port, "_direct", None) is None) == (
        getattr(ref, "_direct", None) is None)
    if public:
        ref._direct = port._direct = None
    return ref, port


@pytest.mark.parametrize("mechanism", MECHANISMS)
@pytest.mark.parametrize("name", sorted(_INSTANCES))
def test_router_matches_reference(name, mechanism):
    prob = _INSTANCES[name]()
    lg, lg_port = _level_rates(prob, mechanism)
    x_ref, s_ref = jax_router.lexmm_route(prob, lg)
    x, s = flowrouter.lexmm_route_np(_port(prob), lg_port)
    assert s == s_ref >= 1
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=ROUTER_ATOL)
    ref, port = _pair(prob, mechanism)
    x_ref, st_ref = ref.solve()
    x, st = port.solve()
    _stats_equal(st, st_ref)
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=ROUTER_ATOL)
    assert port.trace_stages == ref.trace_stages == st.stages


@pytest.mark.parametrize("mechanism", MECHANISMS)
@pytest.mark.parametrize("name", ["fig2", "cell48x8"])
def test_cold_router_matches_reference(name, mechanism):
    prob = _INSTANCES[name]()
    lg, lg_port = _level_rates(prob, mechanism)
    x_ref, s_ref = jax_router.lexmm_route_cold(prob, lg)
    x, s = flowrouter.lexmm_route_cold_np(_port(prob), lg_port)
    assert s == s_ref
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=ROUTER_ATOL)
    # the warm router against the cold one: the reference's own gate
    x_warm, _ = flowrouter.lexmm_route_np(_port(prob), lg_port)
    scale = max(1.0, float(np.abs(x.sum(axis=1)).max()))
    assert np.abs(x_warm.sum(axis=1) - x.sum(axis=1)).max() <= 1e-6 * scale


def _cell():
    return _INSTANCES["cell48x8"]()


def _warm_sequences():
    """tests/test_flowrouter_warm.py's sequences, as (name, steps): each
    step is a callable on a router returning its (x, stats)."""
    prob = _cell()
    lg = jax_baselines.level_rate_matrix(prob, "tsf")
    scale = np.ones(prob.num_servers)
    scale[0] = 0.5
    eff = type(prob)(prob.demands, prob.capacities * scale[:, None],
                     prob.weights, prob.eligibility)
    lg_eff = jax_baselines.level_rate_matrix(eff, "tsf")
    active = np.ones(prob.num_users, dtype=bool)

    def depart(router, stage):
        mask = active.copy()
        mask[router.users[router._trace[stage].frozen[0]]] = False
        return router.resolve(active=mask)

    def arrive_after_absent(router):
        mask = active.copy()
        mask[3] = False
        router.solve(active=mask)
        return router.resolve()

    def capacity(router):
        assert not router.update(level_gamma=lg_eff, capacity_scale=scale)
        return router.resolve()

    def noop(router):
        assert router.update(level_gamma=lg,
                             capacity_scale=np.ones(prob.num_servers))
        return router.resolve()

    return {
        "verify": [lambda r: r.solve(), lambda r: r.resolve()],
        "departure_middle": [lambda r: r.solve(), lambda r: depart(r, 1)],
        "departure_last": [lambda r: r.solve(), lambda r: depart(r, -1)],
        "arrival_fallback": [arrive_after_absent],
        "capacity_update": [lambda r: r.solve(), capacity,
                            lambda r: r.resolve()],
        "noop_update": [lambda r: r.solve(), noop],
    }


@pytest.mark.parametrize("public", [False, True], ids=["default", "linprog"])
@pytest.mark.parametrize("sequence", sorted(_warm_sequences()))
def test_warm_sequences_match_reference(sequence, public):
    ref, port = _pair(_cell(), "tsf", public=public)
    modes = []
    for step in _warm_sequences()[sequence]:
        x_ref, st_ref = step(ref)
        x, st = step(port)
        _stats_equal(st, st_ref)
        np.testing.assert_allclose(x, x_ref, rtol=0, atol=ROUTER_ATOL)
        modes.append(st.mode)
    want = {"verify": ["warm", "verify"],
            "departure_middle": ["warm", "incremental"],
            "departure_last": ["warm", "incremental"],
            "arrival_fallback": ["fallback"],
            "capacity_update": ["warm", "fallback", "verify"],
            "noop_update": ["warm", "verify"]}[sequence]
    assert modes == want
    if public:
        assert st.backend == "linprog"


def test_router_edge_cases_match_reference():
    # R = 1 (plain max-flow), a user eligible nowhere, and no user at all
    probs = [
        JaxProblem(
            demands=np.array([[2.0], [2.0], [1.0]]),
            capacities=np.array([[10.0], [8.0]]), weights=np.ones(3),
            eligibility=np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])),
        JaxProblem(
            demands=np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
            capacities=np.array([[6.0, 6.0]]), weights=np.ones(3),
            eligibility=np.array([[1.0], [0.0], [1.0]])),
        JaxProblem(
            demands=np.array([[1.0, 1.0]]), capacities=np.array([[4.0, 4.0]]),
            weights=np.ones(1), eligibility=np.array([[0.0]])),
    ]
    for prob in probs:
        ref, port = _pair(prob, "tsf")
        for call in ("solve", "resolve"):
            x_ref, st_ref = getattr(ref, call)()
            x, st = getattr(port, call)()
            _stats_equal(st, st_ref)
            np.testing.assert_allclose(x, x_ref, rtol=0, atol=ROUTER_ATOL)
    np.testing.assert_allclose(
        flowrouter.lexmm_route_np(_port(probs[0]), _level_rates(
            probs[0], "tsf")[1])[0].sum(axis=1), [2.5, 2.5, 8.0], atol=1e-9)


def test_router_rejects_like_reference():
    from repro.core.gamma import gamma_matrix
    prob = jax_instances.dense_random_instance(12, 4)
    lg = gamma_matrix(prob)                  # per-server rates: refused
    with pytest.raises(ValueError, match="server-independent"):
        jax_router.lexmm_route(prob, lg)
    with pytest.raises(ValueError, match="server-independent"):
        flowrouter.lexmm_route_np(_port(prob), lg)
    _, port = _pair(_cell(), "tsf")
    port.solve()
    support = _level_rates(_cell(), "tsf")[1].copy()
    support[0] = 0.0
    with pytest.raises(ValueError, match="support"):
        port.update(level_gamma=support)


@pytest.mark.parametrize("mechanism", MECHANISMS)
@pytest.mark.parametrize("name", sorted(_INSTANCES))
def test_engine_lexmm_matches_reference(x64, name, mechanism):
    prob = _INSTANCES[name]()
    a_ref, i_ref = jax_engine.solve(prob, mechanism, backend="jax",
                                    placement="lexmm")
    a, info = engine.solve(_port(prob), mechanism, placement="lexmm",
                           device="cpu")
    np.testing.assert_allclose(a.x, a_ref.x, rtol=0, atol=ATOL)
    got, want = dataclasses.asdict(info), dataclasses.asdict(i_ref)
    for key in got:
        if key == "stranded_frac":
            assert abs(got[key] - want[key]) <= ATOL
        else:
            assert got[key] == want[key], (key, got[key], want[key])
    assert info.placement == "lexmm" and info.fill_engine == ""
    assert info.lp_calls == 0 and info.converged and info.residual == 0.0


def test_engine_lexmm_fig1_paper_values():
    a, info = engine.solve(_port(jax_instances.fig1_instance()), "tsf",
                           placement="lexmm", device="cpu")
    np.testing.assert_allclose(a.tasks_per_user, [2.0, 2.0, 8.0], atol=1e-6)
    assert info.rounds >= 1


@pytest.mark.parametrize("kw", [dict(layout="bucketed"),
                                dict(accel="newton"),
                                dict(placement="bestfit")])
@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_engine_lexmm_rejects_like_reference(x64, mechanism, kw):
    kw = {"placement": "lexmm", **kw}
    prob = jax_instances.fig2_instance()
    with pytest.raises(Exception) as want:
        jax_engine.solve(prob, mechanism, backend="jax", **kw)
    with pytest.raises(type(want.value)):
        engine.solve(_port(prob), mechanism, device="cpu", **kw)


def test_engine_lexmm_takes_anderson_like_reference(x64):
    # lexmm is one-shot exact: accel is recorded, nothing is accelerated
    prob = jax_instances.fig2_instance()
    _, i_ref = jax_engine.solve(prob, "tsf", backend="jax",
                                placement="lexmm", accel="anderson")
    _, info = engine.solve(_port(prob), "tsf", placement="lexmm",
                           accel="anderson", device="cpu")
    assert info.accel == i_ref.accel == "anderson"
    assert info.accel_hits == i_ref.accel_hits == 0


def _stream(num_events):
    prob = jax_instances.cell_cluster_instance(num_users=16, num_servers=4,
                                               cells=2, seed=3)[0]
    events = jax_churn.poisson_churn_events(
        prob.num_users, prob.num_servers, horizon=200, arrival_rate=0.8,
        departure_rate=0.8, seed=7)[:num_events]
    by_time = {}
    for ev in events:
        by_time.setdefault(ev.time, []).append(ev)
    return prob, sorted(by_time.items())


ROUTER_FIELDS = ("rounds", "lp_calls", "warm_hits", "warm_fallbacks",
                 "router_mode", "n_events", "active_users", "fill_engine",
                 "fill_iters", "layout", "bucket_max", "layout_rebuilds",
                 "accel", "rounds_to_tol", "residual", "cold_rounds")


@pytest.mark.parametrize("mechanism", ["tsf", "cdrfh"])
def test_lexmm_churn_matches_reference(mechanism):
    # test_200_event_stream's instance and stream, cut to its first 48
    # events (the reference's telemetry runs the Pallas VDS interpreted)
    prob, batches = _stream(48)
    ref = jax_churn.ChurnSimulator(prob, mechanism=mechanism,
                                   placement="lexmm")
    port = churn.ChurnSimulator(_port(prob), mechanism=mechanism,
                                placement="lexmm", device="cpu")
    modes = set()
    for t, batch in [(0.0, [])] + batches:
        r_ref = ref.step(batch, t)
        rec = port.step([churn.ChurnEvent(e.time, e.kind, e.user, e.server,
                                          e.scale) for e in batch], t)
        for field in ROUTER_FIELDS:
            assert getattr(rec, field) == getattr(r_ref, field), (t, field)
        scale = max(1.0, float(np.abs(ref.x).max()))
        np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=ATOL * scale)
        assert abs(rec.min_vds - r_ref.min_vds) <= VDS_RTOL * abs(
            r_ref.min_vds)
        if rec.bottleneck_server != r_ref.bottleneck_server:
            # a tie: the port's pick attains the reference's minimum
            mn, _ = jax_dynamic.min_vds_guarded(
                ref.x, prob.weights, _gamma_eff(ref), ref.active)
            assert mn[rec.bottleneck_server] <= r_ref.min_vds * (
                1 + VDS_RTOL)
        modes.add(rec.router_mode)
    assert {"warm", "incremental"} <= modes
    assert port._lexmm_router is not None


def _gamma_eff(sim):
    from repro.core.gamma import gamma_matrix
    return gamma_matrix(sim._effective_problem())


def test_lexmm_churn_degrade_and_psdsf_identity():
    # a degrade and its restore re-scale the router's rhs (fallbacks);
    # PS-DSF at lexmm is its level tick, with no router
    prob = jax_instances.fig2_instance()
    stream = [(1.0, "degrade", dict(server=1, scale=0.5)),
              (2.0, "departure", dict(user=0)),
              (3.0, "restore", dict(server=1)),
              (4.0, "arrival", dict(user=0))]
    recs = []
    for module, p, extra in ((jax_churn, prob, {}),
                             (churn, _port(prob), {"device": "cpu"})):
        sim = module.ChurnSimulator(p, mechanism="tsf", placement="lexmm",
                                    telemetry=False, **extra)
        out = [sim.step([], 0.0)]
        out += sim.run([module.ChurnEvent(t, k, **kw)
                        for t, k, kw in stream])
        recs.append((sim, out))
    (s_ref, r_ref), (s_port, r_port) = recs
    assert [r.router_mode for r in r_port] == [r.router_mode for r in r_ref]
    assert [r.warm_fallbacks for r in r_port] == [r.warm_fallbacks
                                                  for r in r_ref]
    np.testing.assert_allclose(s_port.x, s_ref.x, rtol=0, atol=ATOL)
    level = churn.ChurnSimulator(_port(prob), telemetry=False, device="cpu")
    lexmm = churn.ChurnSimulator(_port(prob), placement="lexmm",
                                 telemetry=False, device="cpu")
    level.step([], 0.0)
    rec = lexmm.step([], 0.0)
    np.testing.assert_array_equal(lexmm.x, level.x)
    assert rec.router_mode == "" and rec.lp_calls == 0


@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_routed_allocation_matches_reference(mechanism):
    prob = _cell()
    ref = jax_dynamic.DistributedPSDSF(prob, engine="numpy")
    port = dynamic.DistributedPSDSF(_port(prob), device="cpu")
    modes = []
    for change in (None, (5, False), (5, True), None, (11, False)):
        if change is not None:
            ref.set_active(*change)
            port.set_active(*change)
        a_ref = ref.routed_allocation(mechanism)
        a = port.routed_allocation(mechanism)
        np.testing.assert_allclose(a.x, a_ref.x, rtol=0, atol=ATOL)
        _stats_equal(port.router_stats, ref.router_stats)
        modes.append(port.router_stats.mode)
    assert modes == ["warm", "incremental", "fallback", "verify",
                     "incremental"]
    # another mechanism builds its own router
    a_ref = ref.routed_allocation("tsf" if mechanism != "tsf" else "cdrf")
    a = port.routed_allocation("tsf" if mechanism != "tsf" else "cdrf")
    np.testing.assert_allclose(a.x, a_ref.x, rtol=0, atol=ATOL)
    assert port.router_stats.mode == "warm"
