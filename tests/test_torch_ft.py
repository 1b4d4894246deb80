"""The port's fault-tolerance control plane (``repro_torch.ft``, a copy of
``repro/ft/failures.py``) driven by the port's scheduler on the CPU:
the reference's elastic re-allocation and straggler tests, the allocations
before and after a pod failure against the reference's controller over
the reference's scheduler (both at their fixed point, P11: 1e-5 on each
job's replicas), and a straggler's degrade and re-solve."""
import pytest
import torch

from repro import sched as ref_sched
from repro.ft import ElasticController as RefElasticController
from repro_torch import sched
from repro_torch.ft import (ElasticController, HeartbeatMonitor,
                            RestartEvent, StragglerDetector)

REF_ATOL = 1e-5
FIXED_POINT = dict(tol=1e-12, max_rounds=2000)


def _cluster(mod):
    pods = [
        mod.TPUPod("v5e-a", "v5e", 256, 16, 512, 1600, 100),
        mod.TPUPod("v5e-b", "v5e", 256, 16, 512, 1600, 100),
        mod.TPUPod("v5p-a", "v5p", 128, 95, 512, 2400, 200),
    ]
    jobs = [
        mod.TenantJob("train-32b", 2.0, 64, 700, 32, 300, 10,
                      min_hbm_per_chip=0),
        mod.TenantJob("serve-72b", 1.0, 32, 900, 16, 150, 5,
                      min_hbm_per_chip=90),   # only fits v5p
        mod.TenantJob("train-moe", 1.0, 64, 800, 32, 300, 20),
    ]
    return mod.Cluster(pods), jobs


def _fail_v5e_b(ctl, cluster):
    # all pods beat at t=0; v5e-b goes silent
    for p in cluster.pods:
        ctl.monitor.beat(p.name, 0.0)
    ctl.monitor.beat("v5e-a", 20.0)
    ctl.monitor.beat("v5p-a", 20.0)
    return ctl.on_tick(25.0, {"v5e-b": 7})


def test_elastic_reallocation_on_failure():
    cluster, jobs = _cluster(sched)
    ctl = ElasticController(cluster, jobs,
                            lambda c, j: sched.schedule(c, j, device="cpu"),
                            heartbeat_timeout_s=10)
    before = dict(ctl.allocation)
    after = _fail_v5e_b(ctl, cluster)
    assert any(e.reason == "failure" and e.worker == "v5e-b"
               and e.restored_step == 7 for e in ctl.events)
    assert ctl.events[-1].new_allocation == after
    # capacity loss shrinks everyone: the unconstrained jobs directly,
    # and the v5p-only job because the now-poorer train jobs have lower
    # VDS and reclaim v5p share (correct PS-DSF cluster-wide fairness)
    assert after["train-32b"] < before["train-32b"]
    assert after["serve-72b"] <= before["serve-72b"] + 1e-9
    assert after["serve-72b"] > 0
    # a second tick with nothing new changes nothing
    assert ctl.on_tick(26.0, {}) is after and len(ctl.events) == 1


def test_reallocation_matches_reference_controller():
    ref_cluster, ref_jobs = _cluster(ref_sched)
    ref = RefElasticController(
        ref_cluster, ref_jobs,
        lambda c, j: ref_sched.schedule(c, j, **FIXED_POINT),
        heartbeat_timeout_s=10)
    cluster, jobs = _cluster(sched)
    ctl = ElasticController(
        cluster, jobs,
        lambda c, j: sched.schedule(c, j, device="cpu", **FIXED_POINT),
        heartbeat_timeout_s=10)
    pairs = [(ctl.allocation, ref.allocation)]
    pairs.append((_fail_v5e_b(ctl, cluster), _fail_v5e_b(ref, ref_cluster)))
    for got, want in pairs:
        assert got.keys() == want.keys()
        for name in want:
            assert got[name] == pytest.approx(want[name], abs=REF_ATOL), name
    assert [(e.reason, e.worker) for e in ctl.events] == [
        (e.reason, e.worker) for e in ref.events]


def test_straggler_detection():
    det = StragglerDetector(window=8, factor=2.0)
    for _ in range(8):
        for w in ("w0", "w1", "w2", "w3"):
            det.record(w, 1.0 if w != "w2" else 3.5)
    assert det.stragglers() == ["w2"]
    assert StragglerDetector().stragglers() == []
    lone = StragglerDetector()
    for _ in range(5):
        lone.record("w0", 9.0)
    assert lone.stragglers() == []          # no fleet to compare with


def test_straggler_pod_is_degraded_and_resolved():
    cluster, jobs = _cluster(sched)
    ctl = ElasticController(cluster, jobs,
                            lambda c, j: sched.schedule(c, j, device="cpu"))
    before = dict(ctl.allocation)
    for _ in range(4):
        ctl.stragglers.record("v5e-a", 9.0)
        ctl.stragglers.record("v5e-b", 1.0)
        ctl.stragglers.record("v5p-a", 1.1)
    after = ctl.on_tick(1.0, {})
    assert [(e.reason, e.worker) for e in ctl.events] == [("straggler",
                                                           "v5e-a")]
    assert cluster.pods[0].capacity_scale == 0.5
    assert after["train-32b"] < before["train-32b"]
    ctl.on_tick(2.0, {})                     # already at 0.5: no new event
    assert len(ctl.events) == 1


def test_heartbeat_monitor():
    mon = HeartbeatMonitor(["a", "b"], timeout_s=5.0)
    mon.beat("a", 10.0)
    assert mon.dead(12.0) == ["b"]
    mon.add("c", 12.0)
    mon.remove("b")
    mon.remove("missing")
    assert mon.dead(15.0) == [] and mon.dead(17.5) == ["a", "c"]
    ev = RestartEvent(1.0, "failure", "a", 3, {})
    assert (ev.reason, ev.restored_step) == ("failure", 3)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_solve_needs_a_card(no_cuda):
    cluster, jobs = _cluster(sched)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticController(cluster, jobs, sched.schedule)
