"""The port's tick layer (``DistributedPSDSF(engine="torch")``) against the
JAX reference's, on the CPU.

``precision="highest"`` ticks in float64 and is held to the reference's
numpy oracle engine at 1e-12 (the reference's own ``engine="jax"`` raises
at "highest", R2); ``precision="fast"`` ticks in float32 and is held to the
reference's ``engine="jax", precision="fast"`` at 1e-5 x max(1, max|x|).
The instances and visit sequences are the reference tests' own
(``tests/test_layout.py:368``, ``tests/test_accel.py:249-275``).
"""
import numpy as np
import pytest

from repro.core import AllocationProblem as JaxProblem
from repro.core import dynamic as jax_dynamic
from repro.core.instances import cell_cluster_instance, fig2_instance
from repro_torch.core import dynamic
from repro_torch.core.types import AllocationProblem

F64_ATOL = 1e-12
F32_REL = 1e-5


def _port(prob):
    return AllocationProblem(prob.demands, prob.capacities, prob.weights,
                             prob.eligibility)


def _cell():
    return cell_cluster_instance(num_users=128, num_servers=32, cells=8,
                                 seed=2)[0]


def _limit_cycle_instance():
    """tests/test_accel.py's 100 x 20 dense instance (limit-cycling)."""
    rng = np.random.default_rng(0)
    return JaxProblem(rng.uniform(0.05, 2.0, (100, 4)),
                      rng.uniform(5.0, 50.0, (20, 4)),
                      rng.uniform(0.5, 2.0, 100),
                      (rng.random((100, 20)) > 0.3).astype(float))


def _drive(sim):
    """tests/test_layout.py:368's sequence: five full ticks with a
    departure after the third, then a partial tick, then a shuffled one."""
    for t in range(5):
        sim.tick()
        if t == 2:
            sim.set_active(7, False)
    sim.tick(servers=[1, 5, 9])
    sim.tick(shuffle=True)
    return sim


def _pair(prob, jax_kw, **kw):
    ref = jax_dynamic.DistributedPSDSF(prob, **jax_kw, **kw)
    port = dynamic.DistributedPSDSF(_port(prob), engine="torch",
                                    device="cpu",
                                    precision=jax_kw["precision"], **kw)
    return ref, port


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("fill", ["event", "bisect"])
@pytest.mark.parametrize("mode", ["rdm", "tdm"])
def test_highest_matches_numpy_oracle(layout, fill, mode):
    ref, port = _pair(_cell(), dict(engine="numpy", precision="highest"),
                      layout=layout, fill=fill, mode=mode, seed=3)
    assert port.layout == ref.layout == layout
    assert port.bucket_max == ref.bucket_max
    _drive(ref)
    _drive(port)
    assert port.x.dtype == np.float64
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=F64_ATOL)
    assert not port.x[7].any()


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("fill", ["event", "bisect"])
def test_fast_matches_jax_engine(layout, fill):
    ref, port = _pair(_cell(), dict(engine="jax", precision="fast"),
                      layout=layout, fill=fill, seed=5)
    _drive(ref)
    _drive(port)
    scale = max(1.0, float(np.abs(ref.x).max()))
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=F32_REL * scale)


def test_auto_layout_and_utilization_match():
    ref, port = _pair(_cell(), dict(engine="numpy", precision="highest"))
    assert port.layout == ref.layout == "bucketed"
    for sim in (ref, port):
        for _ in range(3):
            sim.tick()
    np.testing.assert_allclose(port.utilization(), ref.utilization(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(port.allocation().x, ref.allocation().x,
                               rtol=0, atol=F64_ATOL)


def test_anderson_ticks_match_numpy_oracle():
    # tests/test_accel.py:249: 30 synchronous full ticks on Fig. 2
    ref, port = _pair(fig2_instance(), dict(engine="numpy",
                                            precision="highest"),
                      accel="anderson")
    for _ in range(30):
        ref.tick()
        port.tick()
    assert (port.accel_hits, port.accel_rejects) == (ref.accel_hits,
                                                     ref.accel_rejects)
    assert port.accel_hits + port.accel_rejects > 0
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(port.x.sum(axis=1), [3.6, 3.6, 8.0, 8.0],
                               atol=1e-6)


def test_anderson_history_restarts_like_the_reference():
    # tests/test_accel.py:262: partial ticks and churn restart the history
    ref, port = _pair(_limit_cycle_instance(),
                      dict(engine="numpy", precision="highest"),
                      accel="anderson", layout="dense")
    for sim in (ref, port):
        for _ in range(6):
            sim.tick()
        assert len(sim._hist_f) > 0
        sim.tick(servers=[0, 1])
        assert len(sim._hist_f) == 0
        sim.tick()
        sim.set_active(3, False)
        assert len(sim._hist_f) == 0
        sim.tick()
    assert (port.accel_hits, port.accel_rejects) == (ref.accel_hits,
                                                     ref.accel_rejects)
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=1e-9)


def test_min_vds_matches_reference():
    ref, port = _pair(_cell(), dict(engine="numpy", precision="highest"),
                      layout="bucketed")
    for sim in (ref, port):
        sim.tick()
        sim.set_active(4, False)
    mn_r, arg_r = ref.min_vds(interpret=True)
    mn_p, arg_p = port.min_vds()
    assert mn_p.dtype == np.float32 and arg_p.dtype == np.int32
    np.testing.assert_allclose(mn_p, mn_r, rtol=1e-6)
    np.testing.assert_array_equal(arg_p, arg_r)
    assert not (arg_p == 4).any()


def test_min_vds_all_inactive_reports_big():
    # every user inactive: each server reports the empty minimum, 3e38
    port = dynamic.DistributedPSDSF(_port(fig2_instance()), device="cpu",
                                    precision="fast")
    port.tick()
    for u in range(port.problem.num_users):
        port.set_active(u, False)
    mn, _ = port.min_vds()
    assert np.all(mn >= 1e38)


@pytest.mark.parametrize("kw", [dict(mode="xdm"), dict(engine="gpu"),
                                dict(engine="jax"),
                                dict(precision="double"),
                                dict(fill="sorted"), dict(accel="newton"),
                                dict(layout="sparse"),
                                dict(placement="nope")])
def test_rejected_values_raise_value_error(kw):
    with pytest.raises(ValueError):
        dynamic.DistributedPSDSF(_port(fig2_instance()), device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(engine="numpy"),
                                dict(placement="headroom"),
                                dict(placement="bestfit")])
def test_unported_values_raise_not_implemented(kw):
    # what still raises: the numpy engine; routed_allocation is ported and
    # runs whatever the placement (headroom and bestfit tick: see the
    # parity tests)
    if kw.get("engine") == "numpy":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dynamic.DistributedPSDSF(_port(fig2_instance()), device="cpu",
                                     **kw)
        return
    sim = dynamic.DistributedPSDSF(_port(fig2_instance()), device="cpu",
                                   **kw)
    ref = jax_dynamic.DistributedPSDSF(fig2_instance(), **kw)
    np.testing.assert_allclose(sim.routed_allocation("tsf").x,
                               ref.routed_allocation("tsf").x, rtol=0,
                               atol=F64_ATOL)


def test_routed_allocation_raises_not_implemented():
    # routed_allocation no longer raises: the host lexmm router is ported;
    # it equals the reference's (across churn: tests/test_torch_lexmm.py)
    sim = dynamic.DistributedPSDSF(_port(fig2_instance()), device="cpu")
    ref = jax_dynamic.DistributedPSDSF(fig2_instance())
    np.testing.assert_allclose(sim.routed_allocation("tsf").x,
                               ref.routed_allocation("tsf").x, rtol=0,
                               atol=F64_ATOL)
    assert sim.router_stats.mode == ref.router_stats.mode == "warm"


def test_lexmm_ticks_like_level():
    level = dynamic.DistributedPSDSF(_port(_cell()), device="cpu")
    lexmm = dynamic.DistributedPSDSF(_port(_cell()), device="cpu",
                                     placement="lexmm")
    for sim in (level, lexmm):
        sim.tick()
    np.testing.assert_array_equal(lexmm.x, level.x)


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("placement", ["headroom", "bestfit"])
def test_repacking_ticks_match_numpy_oracle(placement, mode, layout):
    # every tick ends with the host repack over the active users' gamma
    # (the repack splits by headroom, and a saturated server's headroom is
    # rounding noise of its capacity: the bound is the float64 one, 1e-9)
    ref, port = _pair(_cell(), dict(engine="numpy", precision="highest"),
                      placement=placement, layout=layout, mode=mode, seed=3)
    _drive(ref)
    _drive(port)
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=1e-9)
    assert not port.x[7].any()


@pytest.mark.parametrize("placement", ["headroom", "bestfit"])
def test_repacking_ticks_fast_match_jax_engine(placement):
    # R2: the reference's jax tick runs only at precision="fast"
    ref, port = _pair(_cell(), dict(engine="jax", precision="fast"),
                      placement=placement, fill="bisect", seed=5)
    _drive(ref)
    _drive(port)
    scale = max(1.0, float(np.abs(ref.x).max()))
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=F32_REL * scale)


def test_repacking_anderson_ticks_match_numpy_oracle():
    ref, port = _pair(fig2_instance(), dict(engine="numpy",
                                            precision="highest"),
                      accel="anderson", placement="headroom")
    for _ in range(12):
        ref.tick()
        port.tick()
    assert (port.accel_hits, port.accel_rejects) == (ref.accel_hits,
                                                     ref.accel_rejects)
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=1e-9)


@pytest.mark.parametrize("placement", ["headroom", "bestfit"])
def test_empty_tick_repacks_like_the_reference(placement):
    # a tick over no server is the repack alone: from a state that piles
    # each user's tasks on its first eligible server, it moves tasks, keeps
    # every total and equals the reference's bit for bit
    ref, port = _pair(_cell(), dict(engine="numpy", precision="highest"),
                      placement=placement, layout="dense")
    g = ref.gamma
    first = np.argmax(g > 0, axis=1)
    x0 = np.zeros(g.shape)
    x0[np.arange(g.shape[0]), first] = 0.05 * g[np.arange(g.shape[0]), first]
    for sim in (ref, port):
        sim.x = x0.copy()
        sim.tick(servers=[])
    np.testing.assert_array_equal(port.x, ref.x)
    assert np.abs(port.x - x0).max() > 1e-3
    np.testing.assert_allclose(port.x.sum(axis=1), x0.sum(axis=1), rtol=0,
                               atol=1e-12)


def test_unknown_placement_is_a_key_error():
    with pytest.raises(KeyError):
        jax_dynamic.DistributedPSDSF(fig2_instance(), placement="nope")
    with pytest.raises(KeyError) as err:
        dynamic.DistributedPSDSF(_port(fig2_instance()), device="cpu",
                                 placement="nope")
    assert isinstance(err.value, ValueError)


def test_min_vds_interpret_is_accepted_and_ignored():
    port = dynamic.DistributedPSDSF(_port(_cell()), device="cpu")
    port.tick()
    for a, b in zip(port.min_vds(interpret=True),
                    port.min_vds(interpret=False)):
        np.testing.assert_array_equal(a, b)
