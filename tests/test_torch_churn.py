"""The port's churn simulator against the JAX reference's, on the CPU.

Both packages re-solve in float32 (the reference's ``ChurnSimulator`` runs
its jitted sweep in float32 by design), so the bound is the reference's
own float32 one: x within 1e-5 x max(1, max|x|) (as
``tests/test_batched_solver.py`` holds its float32 solves), min_vds within
1e-6 relative. Round counts, fill budgets, layouts, rebuild and Anderson
counters and bottleneck servers must be equal, record by record. Every
stream is one of the reference tests' own.
"""
import jax
import numpy as np
import pytest

from repro.core import AllocationProblem as JaxProblem
from repro.core.instances import (cell_cluster_instance,
                                  google_cluster_instance,
                                  sparse_cell_instance)
from repro.sched import churn as jax_churn
from repro_torch.core.types import AllocationProblem
from repro_torch.sched import churn

X_REL = 1e-5
VDS_RTOL = 1e-6
#: record fields that must be equal in both packages
EXACT = ("time", "n_events", "rounds", "cold_rounds", "active_users",
         "rounds_to_tol", "bottleneck_server", "lp_calls", "warm_hits",
         "warm_fallbacks", "router_mode", "fill_engine", "fill_iters",
         "layout", "bucket_max", "layout_rebuilds", "accel", "accel_hits",
         "accel_rejects")


def limit_cycle_instance():
    """tests/test_accel.py's 100 x 20 dense instance, whose fixed-order
    sweep limit-cycles just above scheduler tolerance."""
    rng = np.random.default_rng(0)
    return JaxProblem(rng.uniform(0.05, 2.0, (100, 4)),
                      rng.uniform(5.0, 50.0, (20, 4)),
                      rng.uniform(0.5, 2.0, 100),
                      (rng.random((100, 20)) > 0.3).astype(float))


def _port(prob):
    return AllocationProblem(prob.demands, prob.capacities, prob.weights,
                             prob.eligibility)


def _events(module, stream):
    return [module.ChurnEvent(t, kind, **kw) for t, kind, kw in stream]


def _run_both(prob, stream, step0=True, **kw):
    """The same stream through both simulators: (jax sim, jax records,
    torch sim, torch records)."""
    out = []
    for module, p, extra in ((jax_churn, prob, {}),
                             (churn, _port(prob), {"device": "cpu"})):
        sim = module.ChurnSimulator(p, **kw, **extra)
        recs = [sim.step([], 0.0)] if step0 else []
        recs += sim.run(_events(module, stream))
        out += [sim, recs]
    return out


def _assert_same(sj, rj, st, rt, x_rel=X_REL):
    assert len(rj) == len(rt)
    scale = max(float(np.abs(sj.x).max()), 1.0)
    np.testing.assert_allclose(st.x, sj.x, rtol=0, atol=x_rel * scale)
    for a, b in zip(rj, rt):
        for field in EXACT:
            assert getattr(a, field) == getattr(b, field), (field, a, b)
        if np.isfinite(a.min_vds):
            assert abs(b.min_vds - a.min_vds) <= VDS_RTOL * abs(a.min_vds)
        else:
            assert b.min_vds == a.min_vds
        assert b.total_tasks == pytest.approx(a.total_tasks, rel=1e-5)


#: tests/test_layout.py:385's sparse 300 x 64 stream: two departures, the
#: arrival of a user the layout never saw (a rebuild), a degrade
_SPARSE_STREAM = [(1.0, "departure", dict(user=10)),
                  (2.0, "departure", dict(user=20)),
                  (3.0, "arrival", dict(user=1)),
                  (4.0, "degrade", dict(server=2, scale=0.5))]


def _sparse_instance():
    prob, _ = sparse_cell_instance(num_users=300, num_servers=64,
                                   density=0.05, cells=8, multi_frac=0.2,
                                   seed=4)
    active = np.ones(prob.num_users, dtype=bool)
    active[:3] = False
    return prob, active


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("fill,round,rounds", [("bisect", "jacobi", 20),
                                               ("event", "gauss", 4)])
def test_sparse_stream_with_rebuild_matches_jax(layout, fill, round, rounds):
    prob, active = _sparse_instance()
    sj, rj, st, rt = _run_both(prob, _SPARSE_STREAM, initial_active=active,
                               layout=layout, fill=fill, round=round,
                               max_rounds=rounds, tol=0.0)
    _assert_same(sj, rj, st, rt)
    assert all(r.rounds == rounds for r in rt)
    if layout == "bucketed":
        assert rt[0].bucket_max > 0
        assert [r.layout_rebuilds for r in rt] == [0, 0, 0, 1, 0]
        assert st.layout_rebuilds == 1


def test_auto_layout_resolves_like_jax_at_tolerance():
    # the same stream at layout="auto" and the default tol: the layout
    # resolves to the buckets from the initial ACTIVE support in both
    prob, active = _sparse_instance()
    sj, rj, st, rt = _run_both(prob, _SPARSE_STREAM, initial_active=active,
                               fill="bisect", round="jacobi", max_rounds=40)
    assert st.layout == sj.layout == "bucketed"
    _assert_same(sj, rj, st, rt)


def test_section_v_roundtrip_matches_jax():
    # tests/test_batched_solver.py:155: user 3 leaves and comes back, with
    # cold re-solves for the round-count gap and telemetry on
    stream = [(100.0, "departure", dict(user=3)),
              (250.0, "arrival", dict(user=3))]
    sj, rj, st, rt = _run_both(google_cluster_instance()[0], stream,
                               compare_cold=True, telemetry=True)
    _assert_same(sj, rj, st, rt)
    assert [r.active_users for r in rt] == [4, 3, 4]
    assert all(r.cold_rounds > 0 for r in rt)


def test_degrade_restore_matches_jax():
    # tests/test_batched_solver.py:172
    prob, _, _ = cell_cluster_instance(num_users=48, num_servers=8,
                                       cells=2, seed=7)
    stream = [(1.0, "degrade", dict(server=2, scale=0.5)),
              (9.0, "restore", dict(server=2))]
    sj, rj, st, rt = _run_both(prob, stream, telemetry=False, max_rounds=64,
                               tol=1e-4)
    _assert_same(sj, rj, st, rt)
    assert rt[1].total_tasks < rt[0].total_tasks
    np.testing.assert_array_equal(st.cap_scale, sj.cap_scale)
    np.testing.assert_allclose(st.allocation().x, sj.allocation().x,
                               atol=X_REL * max(1.0, float(sj.x.max())))


@pytest.mark.parametrize("accel,tol", [("none", 1e-4), ("anderson", 1e-4),
                                       ("anderson", 0.0)])
def test_accel_stream_matches_jax(accel, tol):
    # tests/test_accel.py:275 on the limit-cycling 100 x 20 instance; at
    # tol=0 every step spends the full budget (P4: Anderson is compared at
    # tol=0 only on limit-cycling instances)
    stream = [(1.0, "departure", dict(user=3)),
              (2.0, "arrival", dict(user=3))]
    sj, rj, st, rt = _run_both(limit_cycle_instance(), stream, accel=accel,
                               tol=tol, max_rounds=300 if tol else 24,
                               telemetry=False)
    _assert_same(sj, rj, st, rt)
    if accel == "anderson":
        assert sum(r.accel_hits + r.accel_rejects for r in rt) > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_poisson_events_equal_jax(seed):
    kw = dict(horizon=30, arrival_rate=3.0, departure_rate=3.0,
              degrade_rate=0.3, seed=seed)
    want = jax_churn.poisson_churn_events(50, 8, **kw)
    got = churn.poisson_churn_events(50, 8, **kw)
    assert [e.__dict__ for e in got] == [e.__dict__ for e in want]
    assert len(got) > 50


def _sim_kwargs_rejected():
    return [dict(mode="rdm", mechanism="psdsf-rdm"), dict(mode="xdm"),
            dict(mechanism="drf"), dict(mechanism="uniform"),
            dict(mechanism="nope"), dict(placement="bestfit"),
            dict(fill="sorted"), dict(round="red"), dict(accel="newton"),
            dict(layout="sparse")]


@pytest.mark.parametrize("kw", _sim_kwargs_rejected())
def test_rejected_values_raise_value_error(kw):
    prob = google_cluster_instance()[0]
    with pytest.raises(ValueError):
        jax_churn.ChurnSimulator(prob, **kw)
    with pytest.raises(ValueError):
        churn.ChurnSimulator(_port(prob), device="cpu", **kw)


def test_unknown_placement_is_rejected():
    # the reference's registry raises KeyError; the port's error is a
    # KeyError and a ValueError, and its message is not quoted
    prob = google_cluster_instance()[0]
    with pytest.raises(KeyError):
        jax_churn.ChurnSimulator(prob, placement="nope")
    with pytest.raises(KeyError) as err:
        churn.ChurnSimulator(_port(prob), placement="nope", device="cpu")
    assert isinstance(err.value, ValueError)
    assert str(err.value).startswith("unknown placement strategy 'nope'")


@pytest.mark.parametrize("kw", [dict(mechanism="tsf", placement="lexmm"),
                                dict(mechanism="cdrf", placement="lexmm"),
                                dict(mechanism="cdrfh", placement="lexmm"),
                                dict(mechanism="tsf", placement="lexmm",
                                     layout="dense", fill="bisect",
                                     round="jacobi")])
def test_unported_values_raise_not_implemented(kw):
    # what still raises: the baselines' host lexmm router (the baselines
    # and headroom run: see the parity tests below)
    prob = _port(google_cluster_instance()[0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        churn.ChurnSimulator(prob, device="cpu", **kw)


def test_event_and_degrade_validation():
    for module in (jax_churn, churn):
        with pytest.raises(ValueError):
            module.ChurnEvent(0.0, "explode", user=1)
    sim = churn.ChurnSimulator(_port(google_cluster_instance()[0]),
                               device="cpu")
    with pytest.raises(ValueError, match="scale"):
        sim.step([churn.ChurnEvent(1.0, "degrade", server=0, scale=1.5)],
                 1.0)
    assert churn.VALID_KINDS == jax_churn.VALID_KINDS
    assert churn.TICKABLE_MECHANISMS == jax_churn.TICKABLE_MECHANISMS


#: a departure, a degrade, the user's return and the restore on the
#: reference's degrade/restore instance (tests/test_batched_solver.py:172)
_BASELINE_STREAM = [(1.0, "departure", dict(user=3)),
                    (2.0, "degrade", dict(server=2, scale=0.5)),
                    (3.0, "arrival", dict(user=3)),
                    (4.0, "restore", dict(server=2))]


def _cell48():
    return cell_cluster_instance(num_users=48, num_servers=8, cells=2,
                                 seed=7)[0]


#: float32 baseline streams against the reference's float32 ones: the
#: level rates are sums of gamma over servers (C-DRFH's the inverse pooled
#: dominant share), so a float32 ulp of a rate moves x by more than a
#: PS-DSF gamma's does; the bound is the float32 path bound of
#: chip_smoke.py (PATH_F32_REL), rounds and every other field exact
BASELINE_X_REL = 1e-4


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("mechanism", ["cdrfh", "tsf", "cdrf"])
def test_baseline_stream_matches_jax(mechanism, layout):
    # level placement, Jacobi rounds of the bisect fill (the kernels'
    # path), float32 in both packages, every round spent (tol=0)
    sj, rj, st, rt = _run_both(_cell48(), _BASELINE_STREAM,
                               mechanism=mechanism, layout=layout,
                               fill="bisect", round="jacobi", max_rounds=20,
                               tol=0.0)
    _assert_same(sj, rj, st, rt, x_rel=BASELINE_X_REL)
    assert all(r.rounds == 20 and r.fill_engine == "bisect" for r in rt)
    assert rt[0].layout == layout


@pytest.mark.parametrize("mechanism", ["cdrfh", "tsf", "cdrf"])
def test_baseline_stream_at_tolerance_matches_jax(mechanism):
    # Gauss-Seidel event fills at tol=1e-4 (the degrade/restore test's):
    # the rounds to acceptance are equal
    sj, rj, st, rt = _run_both(_cell48(), _BASELINE_STREAM,
                               mechanism=mechanism, layout="dense",
                               max_rounds=64, tol=1e-4)
    _assert_same(sj, rj, st, rt, x_rel=BASELINE_X_REL)
    assert max(r.rounds for r in rt) < 64


@pytest.mark.parametrize("mechanism,layout", [("psdsf-rdm", "dense"),
                                              ("psdsf-tdm", "dense"),
                                              ("psdsf-rdm", "bucketed")])
def test_psdsf_headroom_stream_matches_jax(mechanism, layout):
    # the repack-and-refill after each warm re-solve
    sj, rj, st, rt = _run_both(_cell48(), _BASELINE_STREAM,
                               mechanism=mechanism, placement="headroom",
                               layout=layout, fill="bisect", round="jacobi",
                               max_rounds=20, tol=0.0)
    _assert_same(sj, rj, st, rt)
    assert rt[0].layout == layout and rt[0].fill_engine == "bisect"


def _run_reference_op_by_op(prob, stream, **kw):
    """The reference's stream with jit off: its ops one at a time, as the
    port runs them."""
    with jax.disable_jit():
        sim = jax_churn.ChurnSimulator(prob, **kw)
        return sim, [sim.step([], 0.0)] + sim.run(_events(jax_churn, stream))


@pytest.mark.parametrize("name", ["cell48", "google"])
@pytest.mark.parametrize("mechanism", ["cdrfh", "tsf", "cdrf"])
def test_routed_headroom_stream_matches_jax(mechanism, name):
    # the one-shot routed fill a step, in float32. Its event count hangs on
    # float32 saturation tests (free <= 1e-9 x cap after a subtraction
    # rounded at 6e-8): the reference's jitted run fuses ops and moves
    # such a decision by an event on some steps (google tsf: 4, 5, 4, 6, 4
    # jitted; 4, 4, 4, 4, 4 op by op). The port follows the reference op
    # by op exactly, record for record; x stays within 1e-4 of the jitted
    # run either way.
    prob = _cell48() if name == "cell48" else google_cluster_instance()[0]
    kw = dict(mechanism=mechanism, placement="headroom")
    sj, rj = _run_reference_op_by_op(prob, _BASELINE_STREAM, **kw)
    st = churn.ChurnSimulator(_port(prob), device="cpu", **kw)
    rt = [st.step([], 0.0)] + st.run(_events(churn, _BASELINE_STREAM))
    _assert_same(sj, rj, st, rt)
    assert all(r.fill_engine == "" and r.fill_iters == 0
               and r.layout == "dense" and r.accel == "none"
               and r.rounds_to_tol == r.rounds for r in rt)
    jitted, _, _, _ = _run_both(prob, _BASELINE_STREAM, **kw)
    scale = max(1.0, float(np.abs(jitted.x).max()))
    np.testing.assert_allclose(st.x, jitted.x, rtol=0, atol=1e-4 * scale)


def test_routed_headroom_rejects_the_bucketed_layout():
    prob = google_cluster_instance()[0]
    kw = dict(mechanism="tsf", placement="headroom", layout="bucketed")
    with pytest.raises(ValueError, match="bucketed"):
        jax_churn.ChurnSimulator(prob, **kw)
    with pytest.raises(ValueError, match="bucketed"):
        churn.ChurnSimulator(_port(prob), device="cpu", **kw)


def test_interpret_vds_is_accepted_and_ignored():
    prob = google_cluster_instance()[0]
    stream = [(1.0, "departure", dict(user=3))]
    runs = []
    for interpret in (True, False):
        sim = churn.ChurnSimulator(_port(prob), device="cpu",
                                   interpret_vds=interpret)
        runs.append([sim.step([], 0.0)] + sim.run(_events(churn, stream)))
    assert [(r.min_vds, r.bottleneck_server) for r in runs[0]] == \
        [(r.min_vds, r.bottleneck_server) for r in runs[1]]
