"""The port's scheduler layers (``sched/cluster.py``, ``sched/serving.py``)
against the JAX reference's, on the CPU.

The fleet models are host numpy copies: ``Cluster.problem``,
``dispatch_problem``, ``BucketedLayout.from_cluster`` and
``job_from_artifact`` must give the reference's arrays bit for bit. The
solves go through the port's ``engine.solve`` at ``device="cpu"``: held to
the reference's ``engine.solve(backend="jax")`` on the same problem in
float64 at ``tol=0`` with a fixed ``max_rounds`` (1e-9, rounds equal), and
to the reference's own ``schedule``/``admitted_rates`` (its numpy
registry) at 1e-5, as ``tests/test_lexmm.py`` holds a dispatcher's
equilibrium. ``DynamicDispatcher`` at ``precision="highest"`` is held to
the reference's numpy engine at 1e-9 (the reference's JAX engine cannot
tick at "highest"), at ``"fast"`` to its JAX engine at 1e-4 x max(1,
max|x|) (the float32 path bound).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.core import engine as jax_engine
from repro.core.layout import BucketedLayout as JaxBucketedLayout
from repro.sched import cluster as jax_cluster
from repro.sched import serving as jax_serving
from repro_torch.core import ConvergenceError
from repro_torch.core.layout import BucketedLayout
from repro_torch.sched import cluster, serving

ATOL = 1e-9
REF_ATOL = 1e-5
PATH_F32_REL = 1e-4
GENERATIONS = ("v4", "v5e", "v5p", "v6e")
#: against the reference's numpy registry the port runs to its fixed point:
#: each package's default tol stops its own sweep (different damping
#: floors) up to tol x the gamma scale away from it, 3.5e-5 apart on the
#: dispatch fleet; the numpy solver's own distance is ~3e-7
FIXED_POINT = dict(tol=1e-12, max_rounds=2000)


@pytest.fixture()
def x64():
    with jax.enable_x64(True):
        yield


def _fleet(module, seed=0, num_pods=12, num_jobs=40):
    """A seeded fleet in ``module``'s classes: pods over four generations
    and three HBM sizes (one failed, one degraded), jobs whose allow-lists
    are tuples, plain strings, empty or None, with HBM floors and DCN
    needs."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(num_pods):
        pods.append(module.TPUPod(
            f"pod{i}", GENERATIONS[rng.integers(4)],
            int(rng.choice([16, 32, 64, 128])),
            float(rng.choice([16.0, 32.0, 95.0])),
            float(rng.uniform(64, 512)), float(rng.uniform(100, 800)),
            float(rng.choice([0.0, 25.0, 50.0]))))
    jobs = []
    for j in range(num_jobs):
        kind = rng.integers(4)
        gens = (None if kind == 0 else "" if kind == 1
                else GENERATIONS[rng.integers(4)] if kind == 2
                else tuple(rng.choice(GENERATIONS, 2, replace=False)))
        jobs.append(module.TenantJob(
            f"job{j}", float(rng.uniform(0.5, 2.0)),
            float(rng.choice([4, 8, 16])), float(rng.uniform(20, 400)),
            float(rng.uniform(4, 32)), float(rng.uniform(10, 80)),
            float(rng.choice([0.0, 1.0])),
            min_hbm_per_chip=float(rng.choice([0.0, 0.0, 20.0, 60.0])),
            generations=gens, needs_dcn=bool(rng.random() < 0.2)))
    fleet = module.Cluster(pods)
    assert fleet.mark_failed("pod3") and not fleet.mark_failed("pod3")
    assert fleet.degrade("pod5", 0.5) and not fleet.degrade("pod5", 0.7)
    assert not fleet.mark_failed("nope") and not fleet.degrade("nope", 0.1)
    return fleet, jobs


def _dispatch_fleet(module, seed=0, num_groups=6, num_tenants=24):
    """A seeded dispatch fleet in ``module``'s classes: replica groups with
    4k-128k context windows, tenants with matching KV footprints."""
    rng = np.random.default_rng(seed)
    contexts = (4096, 8192, 32768, 131072)
    groups = [module.ReplicaGroup(
        f"g{i}", float(rng.choice([32, 64, 128])),
        float(rng.uniform(64, 512)), float(rng.uniform(2e4, 1e5)),
        max_context=int(contexts[i % 4])) for i in range(num_groups)]
    tenants = []
    for t in range(num_tenants):
        ctx = int(rng.choice(contexts[:3]))
        tenants.append(module.Tenant(
            f"t{t}", float(rng.uniform(0.5, 2.0)), ctx,
            ctx / 8192 * float(rng.uniform(0.3, 1.0)),
            float(rng.uniform(256, 4096))))
    return groups, tenants


def _small_cluster(module):
    """tests/test_engine.py's three-job cluster."""
    pods = [module.TPUPod("a", "v5e", 64, 16, 128, 400, 25),
            module.TPUPod("b", "v5p", 32, 95, 192, 600, 50)]
    jobs = [module.TenantJob("j1", 1.0, 8, 100, 16, 50, 0),
            module.TenantJob("j2", 2.0, 8, 600, 16, 50, 0,
                             min_hbm_per_chip=90),
            module.TenantJob("j3", 1.0, 4, 50, 8, 25, 1, needs_dcn=True)]
    return module.Cluster(pods), jobs


def _small_dispatch(module):
    """tests/test_lexmm.py's dispatcher fleet."""
    groups = [module.ReplicaGroup("g0", 64, 256, 50_000, max_context=32768),
              module.ReplicaGroup("g1", 128, 128, 80_000, max_context=4096)]
    tenants = [module.Tenant("chat", 1.0, 4096, 0.5, 2048),
               module.Tenant("rag", 1.0, 32768, 4.0, 16384),
               module.Tenant("batch", 2.0, 4096, 0.5, 512)]
    return groups, tenants


def _problems_equal(got, want):
    for field in ("demands", "capacities", "weights", "eligibility"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_problem_is_bit_equal(seed):
    (ref, ref_jobs), (port, jobs) = (_fleet(jax_cluster, seed),
                                     _fleet(cluster, seed))
    prob = port.problem(jobs)
    _problems_equal(prob, ref.problem(ref_jobs))
    density = prob.eligibility.mean()
    assert 0.0 < density < 1.0
    assert not prob.capacities[3].any()               # the failed pod
    pod = port.pods[5]                                # the degraded one
    assert pod.capacity_scale == 0.5
    np.testing.assert_array_equal(prob.capacities[5], 0.5 * np.array(
        [pod.chips, pod.chips * pod.hbm_gb_per_chip, pod.host_gb,
         pod.ici_gbps, pod.dcn_gbps]))
    # the vectorized eligibility agrees with the per-pair predicate
    want = np.array([[1.0 if j.eligible(p) else 0.0 for p in port.pods]
                     for j in jobs])
    np.testing.assert_array_equal(prob.eligibility, want)
    lay, ref_lay = (BucketedLayout.from_cluster(port, jobs),
                    JaxBucketedLayout.from_cluster(ref, ref_jobs))
    for field in ("indices", "mask", "counts", "user_ptr", "user_servers"):
        np.testing.assert_array_equal(getattr(lay, field),
                                      getattr(ref_lay, field))
    assert lay.num_users == ref_lay.num_users == len(jobs)


def test_generation_allow_lists_match_reference():
    pods = [cluster.TPUPod(f"p{g}", g, 8, 16, 64, 100, 10)
            for g in GENERATIONS]
    ref_pods = [jax_cluster.TPUPod(f"p{g}", g, 8, 16, 64, 100, 10)
                for g in GENERATIONS]
    for gens in (None, "", (), "v5e", ("v5e",), ["v4", "v6e"], ("x",)):
        jobs = [cluster.TenantJob("j", 1.0, 1, 1, 1, 1, 0,
                                  generations=gens)]
        ref_jobs = [jax_cluster.TenantJob("j", 1.0, 1, 1, 1, 1, 0,
                                          generations=gens)]
        got = cluster._generation_allowed_np(
            jobs, np.array([p.generation for p in pods]))
        want = jax_cluster._generation_allowed(
            ref_jobs, np.array([p.generation for p in ref_pods]))
        np.testing.assert_array_equal(got, want)
        _problems_equal(cluster.Cluster(pods).problem(jobs),
                        jax_cluster.Cluster(ref_pods).problem(ref_jobs))


@pytest.mark.parametrize("seed", [0, 1])
def test_dispatch_problem_is_bit_equal(seed):
    groups, tenants = _dispatch_fleet(serving, seed)
    r_groups, r_tenants = _dispatch_fleet(jax_serving, seed)
    prob = serving.dispatch_problem(groups, tenants)
    _problems_equal(prob, jax_serving.dispatch_problem(r_groups, r_tenants))
    assert 0.0 < prob.eligibility.mean() < 1.0
    assert serving.SERVE_RESOURCES == jax_serving.SERVE_RESOURCES
    assert cluster.RESOURCES == jax_cluster.RESOURCES


def test_job_from_artifact_matches_reference(tmp_path):
    art = {"memory_analysis": {"argument_size_in_bytes": 6e9,
                               "temp_size_in_bytes": 3.5e9,
                               "output_size_in_bytes": 1.25e9},
           "collectives": {"all-reduce": {"wire_bytes": 4.5e10},
                           "all-gather": {"wire_bytes": 1.5e9},
                           "send": {}}}
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(art))
    for kw in (dict(), dict(needs_dcn=True, generations=("v5p",)),
               dict(weight=2.0, replica_chips=64, hbm_per_chip_gb=95.0,
                    min_hbm_per_chip=32.0)):
        got = cluster.job_from_artifact("j", str(path), **kw)
        want = jax_cluster.job_from_artifact("j", str(path), **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _info_equal(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    for key in a:
        if key in ("residual", "stranded_frac"):
            assert abs(a[key] - b[key]) <= ATOL, key
        else:
            assert a[key] == b[key], (key, a[key], b[key])


_SOLVES = [("psdsf-rdm", dict(fill="bisect", round="jacobi",
                              layout="dense")),
           ("psdsf-rdm", dict(fill="bisect", round="jacobi",
                              layout="bucketed")),
           ("psdsf-tdm", dict(fill="event", round="gauss", layout="dense")),
           ("tsf", dict(fill="bisect", round="jacobi", layout="bucketed")),
           ("cdrf", dict(fill="event", round="gauss", layout="dense")),
           ("cdrfh", dict(placement="lexmm")),
           ("psdsf-rdm", dict(placement="headroom", fill="bisect",
                              round="jacobi", layout="dense"))]


@pytest.mark.parametrize("mechanism,kw", _SOLVES)
def test_schedule_detail_matches_jax_engine(x64, mechanism, kw):
    ref, ref_jobs = _fleet(jax_cluster, 0)
    port, jobs = _fleet(cluster, 0)
    kw = dict(kw, max_rounds=24, tol=0.0)
    a_ref, i_ref = jax_engine.solve(ref.problem(ref_jobs), mechanism,
                                    backend="jax", **kw)
    alloc, info = cluster.schedule_detail(port, jobs, mechanism,
                                          device="cpu", **kw)
    np.testing.assert_allclose(alloc.x, a_ref.x, rtol=0, atol=ATOL)
    _info_equal(info, i_ref)
    quotas = cluster.schedule(port, jobs, mechanism, device="cpu", **kw)
    assert list(quotas) == [j.name for j in jobs]
    np.testing.assert_allclose(list(quotas.values()), a_ref.tasks_per_user,
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("mechanism,kw", [
    ("psdsf-rdm", dict(fill="bisect", round="jacobi", layout="dense")),
    ("tsf", dict(fill="event", round="gauss")),
    ("cdrf", dict(placement="lexmm"))])
def test_admitted_rates_matches_jax_engine(x64, mechanism, kw):
    r_groups, r_tenants = _dispatch_fleet(jax_serving, 1)
    groups, tenants = _dispatch_fleet(serving, 1)
    kw = dict(kw, max_rounds=24, tol=0.0)
    a_ref, _ = jax_engine.solve(
        jax_serving.dispatch_problem(r_groups, r_tenants), mechanism,
        backend="jax", **kw)
    rates = serving.admitted_rates(groups, tenants, mechanism, device="cpu",
                                   **kw)
    got = np.array([[rates[t.name][g.name] for g in groups]
                    for t in tenants])
    np.testing.assert_allclose(got, a_ref.x, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mechanism", ["psdsf-rdm", "psdsf-tdm", "cdrf",
                                       "tsf", "uniform"])
def test_schedule_matches_reference_schedule(mechanism):
    ref, ref_jobs = _small_cluster(jax_cluster)
    port, jobs = _small_cluster(cluster)
    want = jax_cluster.schedule(ref, ref_jobs, mechanism=mechanism)
    got = cluster.schedule(port, jobs, mechanism=mechanism, device="cpu",
                           **FIXED_POINT)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=REF_ATOL)
    _, info = cluster.schedule_detail(port, jobs, mechanism, device="cpu")
    _, r_info = jax_cluster.schedule_detail(ref, ref_jobs, mechanism)
    assert info.placement == r_info.placement
    assert info.stranded_frac == pytest.approx(r_info.stranded_frac,
                                               abs=REF_ATOL)


@pytest.mark.parametrize("mechanism,placement", [("psdsf-rdm", "level"),
                                                 ("cdrfh", "level"),
                                                 ("tsf", "lexmm")])
def test_admitted_rates_matches_reference(mechanism, placement):
    want = jax_serving.admitted_rates(*_small_dispatch(jax_serving),
                                      mechanism=mechanism,
                                      placement=placement)
    got = serving.admitted_rates(*_small_dispatch(serving),
                                 mechanism=mechanism, placement=placement,
                                 device="cpu", **FIXED_POINT)
    assert got.keys() == want.keys()
    for t in want:
        for g in want[t]:
            assert got[t][g] == pytest.approx(want[t][g], abs=REF_ATOL)
    assert got["rag"]["g1"] == 0.0           # ineligible stays empty


def test_schedulers_reject_like_reference():
    ref, ref_jobs = _small_cluster(jax_cluster)
    port, jobs = _small_cluster(cluster)
    with pytest.raises(ValueError, match="pooled relaxation"):
        jax_cluster.schedule(ref, ref_jobs, mechanism="drf")
    with pytest.raises(ValueError, match="pooled relaxation"):
        cluster.schedule(port, jobs, mechanism="drf", device="cpu")
    one = [serving.ReplicaGroup("g0", 128, 128, 80_000, max_context=4096)]
    long_ctx = [serving.Tenant("b", 1.0, 32768, 4.0, 16384)]
    with pytest.raises(ValueError, match="pooled relaxation"):
        serving.admitted_rates(one, long_ctx, mechanism="drf",
                               device="cpu")
    with pytest.raises(KeyError):
        cluster.schedule(port, jobs, mechanism="nope", device="cpu")
    # the numpy solvers' knobs are not engine.solve's
    for knob in (dict(adaptive_damping=False), dict(server_order="random")):
        with pytest.raises(TypeError):
            cluster.schedule(port, jobs, device="cpu", **knob)
        with pytest.raises(TypeError):
            serving.admitted_rates(*_small_dispatch(serving), device="cpu",
                                   **knob)


def test_small_budget_raises_convergence_error():
    port, jobs = _fleet(cluster, 0)
    kw = dict(max_rounds=1, tol=1e-12, loose_tol=1e-12, device="cpu")
    with pytest.raises(ConvergenceError, match="residual") as err:
        cluster.schedule(port, jobs, **kw)
    assert isinstance(err.value, RuntimeError)
    with pytest.raises(ConvergenceError, match="serving dispatch"):
        serving.admitted_rates(*_dispatch_fleet(serving, 0), **kw)


def _dispatcher_pair(ref_kw, port_kw, small=True):
    fleet = _small_dispatch if small else (
        lambda m: _dispatch_fleet(m, 2, num_groups=12, num_tenants=72))
    ref = jax_serving.DynamicDispatcher(*fleet(jax_serving), **ref_kw)
    port = serving.DynamicDispatcher(*fleet(serving), device="cpu",
                                     **port_kw)
    return ref, port


def _churn(disp):
    for _ in range(3):
        disp.tick()
    name = disp.tenants[1].name
    disp.set_active(name, False)
    disp.tick()
    disp.set_active(name, True)
    disp.tick(groups=[0, 1])


@pytest.mark.parametrize("small", [True, False], ids=["small", "fleet"])
@pytest.mark.parametrize("fill,layout", [("event", "auto"),
                                         ("bisect", "dense"),
                                         ("bisect", "bucketed")])
def test_dispatcher_highest_matches_numpy_engine(fill, layout, small):
    ref, port = _dispatcher_pair(
        dict(engine="numpy", fill=fill, layout=layout),
        dict(fill=fill, layout=layout), small=small)
    assert port.sim.engine == "torch" and port.sim.layout == ref.sim.layout
    for _ in range(5):
        ref.tick()
        port.tick()
    np.testing.assert_allclose(port.sim.x, ref.sim.x, rtol=0, atol=ATOL)
    _churn(ref)
    _churn(port)
    np.testing.assert_allclose(port.sim.x, ref.sim.x, rtol=0, atol=ATOL)
    assert port.quotas().keys() == ref.quotas().keys()
    np.testing.assert_allclose(port.utilization(), ref.utilization(),
                               rtol=0, atol=ATOL)
    mn, arg = port.sim.min_vds()
    mn_ref, arg_ref = ref.sim.min_vds()
    np.testing.assert_allclose(mn, mn_ref, rtol=1e-6)


@pytest.mark.parametrize("fill", ["event", "bisect"])
def test_dispatcher_fast_matches_jax_engine(fill):
    ref, port = _dispatcher_pair(
        dict(engine="jax", precision="fast", fill=fill),
        dict(precision="fast", fill=fill), small=False)
    _churn(ref)
    _churn(port)
    scale = max(1.0, float(np.abs(ref.sim.x).max()))
    np.testing.assert_allclose(port.sim.x, ref.sim.x, rtol=0,
                               atol=PATH_F32_REL * scale)


def test_dispatcher_equilibrium_matches_admitted_rates():
    groups, tenants = _small_dispatch(serving)
    disp = serving.DynamicDispatcher(groups, tenants, device="cpu")
    for _ in range(30):
        disp.tick()
    quotas = disp.quotas()
    want = serving.admitted_rates(groups, tenants, device="cpu",
                                  **FIXED_POINT)
    for t in tenants:
        for g in groups:
            assert quotas[t.name][g.name] == pytest.approx(
                want[t.name][g.name], abs=REF_ATOL)


def test_dispatcher_placement_threads_and_validates():
    groups, tenants = _small_dispatch(serving)
    with pytest.raises(KeyError, match="unknown placement"):
        serving.DynamicDispatcher(groups, tenants, placement="pack-tight",
                                  device="cpu")
    with pytest.raises(NotImplementedError):
        serving.DynamicDispatcher(groups, tenants, engine="numpy",
                                  device="cpu")
    disp = serving.DynamicDispatcher(groups, tenants, placement="headroom",
                                     device="cpu")
    level = serving.DynamicDispatcher(groups, tenants, device="cpu")
    lexmm = serving.DynamicDispatcher(groups, tenants, placement="lexmm",
                                      device="cpu")
    ref = jax_serving.DynamicDispatcher(*_small_dispatch(jax_serving),
                                        placement="headroom")
    for _ in range(8):
        for d in (disp, level, lexmm, ref):
            d.tick()
    np.testing.assert_allclose(disp.sim.x.sum(axis=1),
                               level.sim.x.sum(axis=1), atol=1e-6)
    np.testing.assert_allclose(disp.sim.x, ref.sim.x, rtol=0, atol=ATOL)
    prob = serving.dispatch_problem(groups, tenants)
    usage = np.einsum("nk,nr->kr", disp.sim.x, prob.demands)
    assert (usage <= prob.capacities * (1 + 1e-6)).all()
    np.testing.assert_array_equal(lexmm.sim.x, level.sim.x)


@pytest.mark.parametrize("mechanism", ["tsf", "cdrfh"])
def test_routed_quotas_match_reference(mechanism):
    ref, port = _dispatcher_pair(dict(engine="numpy"), dict(), small=False)
    modes = []
    for step in range(4):
        if step == 1:
            ref.set_active("t3", False)
            port.set_active("t3", False)
        if step == 2:
            ref.set_active("t3", True)
            port.set_active("t3", True)
        want = ref.routed_quotas(mechanism)
        got = port.routed_quotas(mechanism)
        assert got.keys() == want.keys()
        np.testing.assert_allclose(
            [[got[t][g] for g in got[t]] for t in got],
            [[want[t][g] for g in want[t]] for t in want], rtol=0, atol=ATOL)
        assert port.sim.router_stats.mode == ref.sim.router_stats.mode
        assert port.sim.router_stats.lp_calls == \
            ref.sim.router_stats.lp_calls
        modes.append(port.sim.router_stats.mode)
    assert modes[0] == "warm" and modes[2] == "fallback"
