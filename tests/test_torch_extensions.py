"""The port's Section IV gamma-direct solve (``repro_torch.core.
extensions``) against the reference's (``repro.core.extensions``), on the
CPU in float64.

  * Fig. 4, the co-processor scenario and the single-server weighted
    max-min give the reference's x and time shares within 1e-8, for every
    fill, round and layout; the reference's Gauss-Seidel loop is
    undamped, and so is the port's (``stall=False``): with the event or
    the bisect fill it takes the reference's rounds;
  * seeded sparse gamma instances give the reference's per-user totals
    within 1e-8 at every fill x round x layout, and with Anderson mixing,
    both packages run to tol 1e-12;
  * the Jacobi bisect round runs ``ops.fill_cluster`` in TDM mode on the
    dense layout and ``ops.fill_cluster_bucketed`` on the bucketed one,
    one event a round;
  * the port's TDM checkers certify a gamma-direct allocation from its
    gamma (feasibility, sharing incentive, the Theorem 2 fixed point) and
    catch a planted violation; the checkers that need demands refuse it;
  * ``GammaProblem`` rejects what the reference's rejects, with the same
    messages; the solve rejects the axis values the engine rejects.
"""
import numpy as np
import pytest

from repro.core import extensions as ref
from repro_torch.core import extensions as port
from repro_torch.core import properties
from repro_torch.core import psdsf_torch
from repro_torch.core.types import Allocation
from repro_torch.kernels.psdsf_fill import ops as fill_ops
from repro_torch.kernels.psdsf_fill_bucketed import ops as b_ops

AXES = [(fill, rnd, lay) for fill in ("event", "bisect")
        for rnd in ("gauss", "jacobi") for lay in ("dense", "bucketed")]
BOUND = 1e-8


def _single_server(pkg):
    return pkg.GammaProblem(gamma=np.array([[3.0], [6.0], [2.0]]),
                            weights=np.array([1.0, 1.0, 2.0]))


EXAMPLES = {
    "fig4": (ref.fig4_instance, port.fig4_instance_np),
    "coprocessor": (ref.coprocessor_instance, port.coprocessor_instance_np),
    "single_server": (lambda: _single_server(ref),
                      lambda: _single_server(port)),
}


@pytest.mark.parametrize("fill,rnd,lay", AXES)
@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_examples_equal_the_reference(example, fill, rnd, lay):
    make_ref, make_port = EXAMPLES[example]
    x_ref, s_ref, info_ref = ref.solve_psdsf_gamma_tdm(make_ref())
    x, s, info = port.solve_psdsf_gamma_tdm_torch(
        make_port(), fill=fill, round=rnd, layout=lay, device="cpu")
    assert info.converged and info_ref.converged
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=BOUND)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=BOUND)
    assert info.layout == lay and info.fill_engine == fill
    if rnd == "gauss":
        assert info.rounds == info_ref.rounds


def test_examples_keep_the_papers_outcomes():
    x, s, _ = port.solve_psdsf_gamma_tdm_torch(port.fig4_instance_np(),
                                               device="cpu")
    np.testing.assert_allclose(x.sum(axis=1), [1.5, 1.0], atol=1e-8)
    np.testing.assert_allclose(s[:, 1], [0.5, 0.5], atol=1e-8)
    np.testing.assert_allclose(s.sum(axis=0), [1.0, 1.0, 1.0], atol=1e-8)
    prob = port.coprocessor_instance_np()
    x, _, _ = port.solve_psdsf_gamma_tdm_torch(prob, device="cpu")
    totals = x.sum(axis=1)
    assert (totals >= prob.gamma.sum(axis=1) / 3 - 1e-9).all()
    assert totals[0] > totals[1]


def _sparse_gamma(seed, n=24, k=6, density=0.4):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 5.0, (n, k)) * (rng.random((n, k)) < density)
    g[g.sum(axis=1) == 0, seed % k] = 1.0
    return g, rng.uniform(0.5, 2.0, n)


@pytest.mark.parametrize("fill,rnd,lay", AXES + [("bisect", "jacobi",
                                                  "bucketed/anderson")])
@pytest.mark.parametrize("seed", range(3))
def test_sparse_instances_equal_the_reference(seed, fill, rnd, lay):
    g, w = _sparse_gamma(seed)
    lay, _, accel = lay.partition("/")
    x_ref, _, info_ref = ref.solve_psdsf_gamma_tdm(
        ref.GammaProblem(g, w), max_rounds=3000, tol=1e-12)
    x, s, info = port.solve_psdsf_gamma_tdm_torch(
        port.GammaProblem(g, w), max_rounds=3000, tol=1e-12, fill=fill,
        round=rnd, layout=lay, accel=accel or "none", device="cpu")
    assert info.converged and info_ref.converged
    np.testing.assert_allclose(x.sum(axis=1), x_ref.sum(axis=1), rtol=0,
                               atol=BOUND)
    np.testing.assert_allclose(s.sum(axis=0), 1.0, atol=1e-9)


@pytest.mark.parametrize("lay", ["dense", "bucketed"])
def test_jacobi_bisect_runs_one_fill_event_a_round(lay, monkeypatch):
    calls = []
    module, name = ((fill_ops, "fill_event_levels") if lay == "dense"
                    else (b_ops, "fill_event_levels_bucketed"))
    plain = getattr(module, name)

    def counted(*a, **k):
        calls.append(a[2].shape)
        return plain(*a, **k)
    monkeypatch.setattr(module, name, counted)
    g, w = _sparse_gamma(1)
    _, _, info = port.solve_psdsf_gamma_tdm_torch(
        port.GammaProblem(g, w), max_rounds=40, tol=0.0, fill="bisect",
        round="jacobi", layout=lay, device="cpu")
    assert info.rounds == 40 and len(calls) == 40
    # the TDM event runs on unit demands: one virtual resource
    assert all(shape[-1] == 1 for shape in calls)


def test_stall_schedule_off_keeps_the_damping():
    g, w = _sparse_gamma(0)
    n, k = g.shape
    args = (np.ones((n, 1)), np.ones((k, 1)), w, g)
    on = psdsf_torch.psdsf_solve_torch(*args, mode="tdm", max_rounds=2000,
                                       tol=1e-10, device="cpu")
    off = psdsf_torch.psdsf_solve_torch(*args, mode="tdm", max_rounds=2000,
                                        tol=1e-10, stall=False,
                                        device="cpu")
    x_ref, _, info_ref = ref.solve_psdsf_gamma_tdm(ref.GammaProblem(g, w),
                                                   max_rounds=2000)
    assert off[1] == info_ref.rounds < on[1]
    np.testing.assert_allclose(off[0].numpy(), x_ref, rtol=0, atol=1e-12)
    # the stall schedule shrinks the damping toward 0.01 and stalls: the
    # reference's 113 rounds become 2,000 that end ~2e-2 off its totals
    assert info_ref.rounds == 113 and on[1] == 2000
    assert np.abs(on[0].numpy().sum(axis=1) - x_ref.sum(axis=1)).max() > 1e-2


TDM_CHECKS = (properties.check_feasible_tdm_torch,
              properties.check_sharing_incentive_torch,
              properties.check_pareto_tdm_torch)


@pytest.mark.parametrize("example", ["fig4", "coprocessor", "sparse"])
def test_tdm_checkers_certify_gamma_direct_allocations(example):
    prob = (port.GammaProblem(*_sparse_gamma(2)) if example == "sparse"
            else EXAMPLES[example][1]())
    x, _, info = port.solve_psdsf_gamma_tdm_torch(prob, max_rounds=3000,
                                                  tol=1e-12, device="cpu")
    assert info.converged
    for check in TDM_CHECKS:
        verdict = check(Allocation(prob, x), device="cpu")
        assert verdict.ok, (check.__name__, verdict)
    first = int(np.argmax((prob.gamma > 0).any(axis=0)))
    planted = x.copy()
    planted[:, first] *= 0.5
    verdict = properties.check_pareto_tdm_torch(Allocation(prob, planted),
                                                device="cpu")
    assert not verdict.ok and verdict.where == (first,)
    planted = x.copy()
    planted[:, first] *= 2.0
    verdict = properties.check_feasible_tdm_torch(Allocation(prob, planted),
                                                  device="cpu")
    assert not verdict.ok and verdict.where == (first,)
    for check in (properties.check_envy_freeness_torch,
                  properties.check_bottleneck_structure_rdm_torch):
        with pytest.raises(ValueError, match="needs demands"):
            check(Allocation(prob, x), device="cpu")


@pytest.mark.parametrize("gamma,weights", [
    (np.ones(3), None), (-np.ones((2, 2)), None),
    (np.ones((2, 2)), np.ones(3)), (np.ones((2, 2)), np.array([1.0, 0.0]))])
def test_gamma_problem_rejects_what_the_reference_rejects(gamma, weights):
    with pytest.raises(ValueError) as want:
        ref.GammaProblem(gamma, weights)
    with pytest.raises(ValueError) as got:
        port.GammaProblem(gamma, weights)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axis,value", [("fill", "newton"),
                                        ("round", "async"),
                                        ("layout", "ragged")])
def test_solve_rejects_unknown_axis_values(axis, value):
    with pytest.raises(ValueError, match=axis):
        port.solve_psdsf_gamma_tdm_torch(port.fig4_instance_np(),
                                         device="cpu", **{axis: value})
