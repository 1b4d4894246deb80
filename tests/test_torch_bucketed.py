"""The port's sparse (bucketed) path and its Anderson mixing against the JAX
reference, on the CPU.

* ``kernels/psdsf_fill_bucketed``: one event of the plain version against
  the Pallas kernel in interpret mode, and the whole-cluster fill against
  the Pallas wrapper and the numpy event oracle;
* ``psdsf_solve_torch(layout="bucketed")`` against ``psdsf_solve_jax`` at
  ``tol=0`` with a fixed round budget (every round x fill x mode, the
  ``servers=`` restriction and a warm start), and against the port's own
  dense solve;
* ``accel="anderson"`` on both layouts (x, rounds, hits, rejects);
* ``engine.solve(layout="auto")``'s ``SolveInfo`` field by field.

Float64 references come from ``jax.enable_x64(True)`` (function-scoped);
the bound is 1e-9 per entry, the paper's examples 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core import gamma_matrix
from repro.core import instances as jax_instances
from repro.core.layout import BucketedLayout as RefLayout
from repro.core.psdsf_jax import _solve_core_bucketed, psdsf_solve_jax
from repro.kernels.psdsf_fill_bucketed import kernel as jax_kernel
from repro.kernels.psdsf_fill_bucketed.ops import fill_cluster_bucketed_padded
from repro.kernels.psdsf_fill_bucketed.ref import fill_cluster_bucketed_ref
from repro_torch.core import engine, instances
from repro_torch.core.layout import BucketedLayout
from repro_torch.core.psdsf_torch import (_solve_core_bucketed_torch,
                                          psdsf_solve_torch)
from repro_torch.core.types import AllocationProblem
from repro_torch.kernels.psdsf_fill_bucketed import ref as port_ref
from repro_torch.kernels.psdsf_fill_bucketed.ops import fill_cluster_bucketed

from conftest import random_problems

ATOL = 1e-9


@pytest.fixture()
def x64():
    with jax.enable_x64(True):
        yield


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _sparse():
    """A cell-structured instance at 6% density: auto resolves bucketed."""
    return jax_instances.sparse_cell_instance(num_users=160, num_servers=16,
                                              cells=4, seed=2)[0]


def _limit_cycle():
    """The 100x20 instance of tests/test_accel.py whose plain sweep
    limit-cycles."""
    rng = np.random.default_rng(0)
    from repro.core import AllocationProblem as RefProblem
    return RefProblem(rng.uniform(0.05, 2.0, (100, 4)),
                      rng.uniform(5.0, 50.0, (20, 4)),
                      rng.uniform(0.5, 2.0, 100),
                      (rng.random((100, 20)) > 0.3).astype(float))


def _degenerate():
    """An empty server bucket and a user eligible nowhere."""
    prob = jax_instances.dense_random_instance(num_users=24, num_servers=6)
    elig = prob.eligibility.copy()
    elig[:, 2] = 0.0
    elig[5, :] = 0.0
    from repro.core import AllocationProblem as RefProblem
    return RefProblem(prob.demands, prob.capacities, prob.weights, elig)


def _gathered(prob, x_ext):
    """The bucket-shaped fill inputs of ``prob`` as both packages take
    them (numpy)."""
    g = gamma_matrix(prob)
    lay = RefLayout.from_support(g > 0)
    idx, mask = lay.indices, lay.mask
    gam_b = np.where(mask, np.take_along_axis(g.T, idx, axis=1), 0.0)
    xeb = np.where(mask, np.take_along_axis(x_ext.T, idx, axis=1), 0.0)
    return (prob.capacities, prob.demands[idx], prob.weights[idx], gam_b,
            xeb, mask)


# ---------------------------------------------------------------------------
# the kernel's plain version and the event loop
# ---------------------------------------------------------------------------

def _event_inputs(seed=4):
    """One mid-loop event on the buckets of the sparse instance: some slots
    frozen, some resources saturated (all of server 0), nonzero frozen
    usage and levels, and the padded slots inert."""
    prob = _sparse()
    rng = np.random.default_rng(seed)
    k, r = prob.num_servers, prob.num_resources
    x_ext = rng.uniform(0.0, 2.0, (prob.num_users, k))
    cap, dem_b, phi_b, gam_b, xeb, mask = _gathered(prob, x_ext)
    live = mask & (gam_b > 0) & (rng.random(mask.shape) > 0.2)
    rate = np.where(live, phi_b * gam_b, 0.0)
    floors = np.where(live, xeb / np.maximum(rate, 1e-300), 0.0)
    frozen = rng.uniform(0.0, 0.3, (k, r)) * cap
    saturated = rng.random((k, r)) < 0.15
    saturated[0] = True
    level = rng.uniform(0.0, 0.5, k)
    return floors, rate, dem_b, cap, frozen, saturated, level


@pytest.mark.parametrize("steps", [48, 5, 0])
def test_event_matches_pallas_f64(x64, steps):
    floors, rate, dem, caps, frozen, sat, level = _event_inputs()
    want = jax_kernel.fill_event_levels_bucketed(
        jnp.asarray(floors), jnp.asarray(rate), jnp.asarray(dem),
        jnp.asarray(caps), jnp.asarray(frozen), jnp.asarray(sat, jnp.float64),
        jnp.asarray(level), steps=steps, interpret=True)
    got = port_ref.fill_event_levels_bucketed(
        _t(floors), _t(rate), _t(dem), _t(caps), _t(frozen),
        torch.as_tensor(sat), _t(level), steps=steps)
    for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                            got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0,
                                   atol=ATOL, err_msg=name)


_FILL_CASES = [("fig1", jax_instances.fig1_instance),
               ("fig2", jax_instances.fig2_instance),
               ("dense_random", jax_instances.dense_random_instance),
               ("sparse_cell", _sparse), ("degenerate", _degenerate)] + [
    (f"random{i}", (lambda i=i: random_problems(3, seed=13)[i]))
    for i in range(3)]


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("name,prob_fn", _FILL_CASES,
                         ids=[c[0] for c in _FILL_CASES])
def test_fill_cluster_matches_pallas_and_oracle_f64(x64, name, prob_fn, mode):
    prob = prob_fn()
    x_ext = np.random.default_rng(9).uniform(
        0.0, 2.0, (prob.num_users, prob.num_servers))
    arrays = _gathered(prob, x_ext)
    got = fill_cluster_bucketed(*map(_t, arrays[:5]),
                                torch.as_tensor(arrays[5]), mode=mode).numpy()
    pallas = fill_cluster_bucketed_padded(*arrays, mode=mode, interpret=True)
    oracle = fill_cluster_bucketed_ref(*arrays, mode=mode)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL)
    mask = arrays[5]
    assert (got[~mask] == 0.0).all()          # padded slots stay 0


def test_fill_cluster_f32_pin():
    # the reference's float32 bound for the bisect fill, 5e-6 * scale
    prob = _sparse()
    x_ext = np.random.default_rng(2).uniform(
        0.0, 2.0, (prob.num_users, prob.num_servers))
    arrays = _gathered(prob, x_ext)
    got = fill_cluster_bucketed(*(_t(a, torch.float32) for a in arrays[:5]),
                                torch.as_tensor(arrays[5]), mode="rdm")
    assert got.dtype == torch.float32
    want = fill_cluster_bucketed_ref(*arrays, mode="rdm")
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got.double().numpy() - want).max()) <= 5e-6 * scale


def test_plain_twin_is_the_same_loop():
    prob = _sparse()
    x_ext = np.random.default_rng(3).uniform(
        0.0, 2.0, (prob.num_users, prob.num_servers))
    arrays = _gathered(prob, x_ext)
    args = (*map(_t, arrays[:5]), torch.as_tensor(arrays[5]))
    np.testing.assert_array_equal(
        fill_cluster_bucketed(*args).numpy(),
        port_ref.fill_cluster_bucketed_plain(*args).numpy())
    with pytest.raises(ValueError, match="mode"):
        fill_cluster_bucketed(*args, mode="xdm")


# ---------------------------------------------------------------------------
# the bucketed solve
# ---------------------------------------------------------------------------

def _buckets(prob):
    lay = RefLayout.from_support(gamma_matrix(prob) > 0)
    return lay.indices, lay.mask


def _jax_solve(prob, **kw):
    g = gamma_matrix(prob)
    if kw.get("layout") == "bucketed":
        kw["buckets"] = tuple(map(jnp.asarray, _buckets(prob)))
    out = psdsf_solve_jax(jnp.asarray(prob.demands),
                          jnp.asarray(prob.capacities),
                          jnp.asarray(prob.weights), jnp.asarray(g), **kw)
    return (np.asarray(out[0]), int(out[1]), float(out[2])) + tuple(
        int(v) for v in out[3:])


def _torch_solve(prob, **kw):
    if kw.get("layout") == "bucketed":
        kw["buckets"] = _buckets(prob)
    out = psdsf_solve_torch(prob.demands, prob.capacities, prob.weights,
                            gamma_matrix(prob), device="cpu", **kw)
    return (out[0].numpy(), out[1], float(out[2])) + tuple(out[3:])


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("fill", ["event", "bisect"])
@pytest.mark.parametrize("round", ["gauss", "jacobi"])
def test_bucketed_solve_matches_jax_f64(x64, round, fill, mode):
    prob = _sparse()
    kw = dict(mode=mode, max_rounds=16, tol=0.0, fill=fill, round=round,
              layout="bucketed")
    xj, rj, resj = _jax_solve(prob, **kw)
    xt, rt, rest = _torch_solve(prob, **kw)
    assert xt.dtype == np.float64
    # Gauss-Seidel reaches an exact fixed point (residual 0.0) on this
    # instance in 2 rounds in both packages; Jacobi runs the whole budget
    assert rt == rj == (2 if round == "gauss" else 16)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=ATOL)
    assert abs(rest - resj) <= ATOL


@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss"),
                                        ("event", "jacobi"),
                                        ("bisect", "gauss")])
def test_restricted_warm_sweep_matches_jax_core(x64, fill, round):
    # the servers= restriction, alpha0 and a warm start of the reference's
    # _solve_core_bucketed: only the listed servers' buckets move
    prob = _sparse()
    g = gamma_matrix(prob)
    x0 = np.random.default_rng(1).uniform(0.0, 1.0, g.shape) * (g > 0)
    idx, mask = _buckets(prob)
    servers = np.array([1, 4, 6, 13], dtype=np.int32)
    arrays = (prob.demands, prob.capacities, prob.weights, g, x0, idx, mask)
    xj, rj, _ = _solve_core_bucketed(*map(jnp.asarray, arrays), "rdm", 10,
                                     0.0, servers=jnp.asarray(servers),
                                     alpha0=0.3, fill=fill, round_mode=round)
    xt, rt, _ = _solve_core_bucketed_torch(
        *map(torch.as_tensor, arrays), "rdm", 10, 0.0, servers=servers,
        alpha0=0.3, fill=fill, round_mode=round)
    assert rt == int(rj) == 10
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=ATOL)
    untouched = np.setdiff1d(np.arange(g.shape[1]), servers)
    np.testing.assert_array_equal(xt.numpy()[:, untouched], x0[:, untouched])


@pytest.mark.parametrize("fill,round,mode", [("bisect", "jacobi", "rdm"),
                                             ("bisect", "jacobi", "tdm"),
                                             ("event", "gauss", "rdm")])
def test_warm_start_from_jax_fixed_point(x64, fill, round, mode):
    prob = _sparse()
    kw = dict(mode=mode, fill=fill, round=round, layout="bucketed")
    x_star, _, _ = _jax_solve(prob, max_rounds=600, tol=1e-13, **kw)
    xt, rounds, _ = _torch_solve(prob, x0=x_star, max_rounds=8, tol=1e-12,
                                 **kw)
    assert rounds <= 8
    np.testing.assert_allclose(xt, x_star, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,prob_fn", [("sparse_cell", _sparse),
                                          ("degenerate", _degenerate),
                                          ("fig2",
                                           jax_instances.fig2_instance)])
@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss")])
def test_bucketed_equals_port_dense(name, prob_fn, fill, round):
    # the bucketed sweep is the dense sweep on the support: same trajectory
    prob = prob_fn()
    kw = dict(mode="rdm", max_rounds=20, tol=0.0, fill=fill, round=round)
    xd, rd, resd = _torch_solve(prob, layout="dense", **kw)
    xb, rb, resb = _torch_solve(prob, layout="bucketed", **kw)
    # Gauss-Seidel reaches an exact fixed point early on the first two
    assert rd == rb
    np.testing.assert_allclose(xb, xd, rtol=0, atol=ATOL)
    assert abs(resb - resd) <= ATOL


def test_final_x_is_scatter_added():
    # padded slots point at real users; a masked 0.0 is added there,
    # never written over a real entry
    prob = _degenerate()
    x, *_ = _torch_solve(prob, layout="bucketed", max_rounds=30, tol=0.0,
                         fill="bisect", round="jacobi")
    g = gamma_matrix(prob)
    assert (x[g == 0] == 0.0).all() and (x[:, 2] == 0.0).all()
    assert x[g > 0].max() > 0.0


def test_bucketed_rejects_missing_buckets_and_auto():
    prob = instances.fig1_instance()
    g = gamma_matrix(prob)
    with pytest.raises(ValueError, match="buckets"):
        psdsf_solve_torch(prob.demands, prob.capacities, prob.weights, g,
                          layout="bucketed", device="cpu")
    with pytest.raises(ValueError, match="auto"):
        psdsf_solve_torch(prob.demands, prob.capacities, prob.weights, g,
                          layout="auto", device="cpu")


# ---------------------------------------------------------------------------
# Anderson mixing, both layouts
# ---------------------------------------------------------------------------

# limit-cycling instances run the whole budget at tol=0; fig2 converges to
# an exact fixed point, where accept/reject decisions between residuals of
# a few ulps are noise, so it stops at tol=1e-10 (tests/test_accel.py)
_ACCEL_CASES = [("limit_cycle", _limit_cycle, 40, 0.0),
                ("cell96x16", lambda: jax_instances.cell_cluster_instance(
                    96, 16, cells=4)[0], 40, 0.0),
                ("fig2", jax_instances.fig2_instance, 64, 1e-10)]


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("fill,round", [("bisect", "jacobi"),
                                        ("event", "gauss")])
@pytest.mark.parametrize("name,prob_fn,rounds,tol", _ACCEL_CASES,
                         ids=[c[0] for c in _ACCEL_CASES])
def test_anderson_matches_jax_f64(x64, name, prob_fn, rounds, tol, fill,
                                  round, layout):
    prob = prob_fn()
    kw = dict(mode="rdm", max_rounds=rounds, tol=tol, fill=fill, round=round,
              layout=layout, accel="anderson")
    xj, rj, resj, hj, rejj = _jax_solve(prob, **kw)
    xt, rt, rest, ht, rejt = _torch_solve(prob, **kw)
    assert (rt, ht, rejt) == (rj, hj, rejj)
    assert ht + rejt > 0
    np.testing.assert_allclose(xt, xj, rtol=0, atol=ATOL)
    assert abs(rest - resj) <= ATOL


def test_anderson_tdm_and_tolerance_exit_match_jax(x64):
    prob = _limit_cycle()
    kw = dict(mode="tdm", max_rounds=300, tol=1e-4, fill="bisect",
              round="jacobi", layout="bucketed", accel="anderson")
    xj, rj, resj, hj, rejj = _jax_solve(prob, **kw)
    xt, rt, rest, ht, rejt = _torch_solve(prob, **kw)
    assert (rt, ht, rejt) == (rj, hj, rejj)
    assert rest <= 1e-4 * gamma_matrix(prob).max()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=ATOL)


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
def test_anderson_certifies_the_limit_cycle(layout):
    # plain Jacobi stalls above tol on this instance; Anderson certifies
    prob = _limit_cycle()
    kw = dict(mode="rdm", max_rounds=300, tol=1e-4, fill="bisect",
              round="jacobi", layout=layout)
    scale = gamma_matrix(prob).max()
    _, r_plain, res_plain = _torch_solve(prob, **kw)
    _, r_acc, res_acc, hits, _ = _torch_solve(prob, accel="anderson", **kw)
    assert res_acc <= 1e-4 * scale and hits > 0
    assert r_acc < r_plain or res_plain > 1e-4 * scale


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("name,want", [("fig1", [3.0, 3.0, 6.0]),
                                       ("fig2", [3.6, 3.6, 8.0, 8.0])])
def test_paper_values_under_anderson(layout, name, want):
    prob = getattr(instances, f"{name}_instance")()
    alloc, info = engine.solve(prob, "psdsf-rdm", device="cpu",
                               fill="bisect", round="jacobi", tol=1e-9,
                               max_rounds=512, layout=layout,
                               accel="anderson")
    assert info.converged and not info.approx and info.layout == layout
    np.testing.assert_allclose(alloc.tasks_per_user, want, atol=1e-6)


# ---------------------------------------------------------------------------
# engine.solve at the default layout
# ---------------------------------------------------------------------------

def _port(prob):
    return AllocationProblem(prob.demands, prob.capacities, prob.weights,
                             prob.eligibility)


_FIELDS = ("rounds", "converged", "approx", "fill_iters", "fill_engine",
           "layout", "bucket_max", "placement", "accel", "accel_hits",
           "accel_rejects", "rounds_to_tol", "lp_calls", "servers_skipped")


@pytest.mark.parametrize("mechanism", ["psdsf-rdm", "psdsf-tdm"])
@pytest.mark.parametrize("accel", ["none", "anderson"])
@pytest.mark.parametrize("name,prob_fn,layout", [
    ("sparse_cell", _sparse, "bucketed"),
    ("fig2", jax_instances.fig2_instance, "dense"),
    ("limit_cycle", _limit_cycle, "dense")])
def test_auto_solveinfo_matches_reference_engine(x64, mechanism, accel, name,
                                                 prob_fn, layout):
    prob = prob_fn()
    kw = dict(fill="bisect", round="jacobi", tol=1e-10, max_rounds=24,
              accel=accel)
    a_ref, i_ref = jax_engine.solve(prob, mechanism, backend="jax", **kw)
    a, info = engine.solve(_port(prob), mechanism, device="cpu", **kw)
    assert info.layout == i_ref.layout == layout
    for field in _FIELDS:
        assert getattr(info, field) == getattr(i_ref, field), field
    assert info.stranded_frac == pytest.approx(i_ref.stranded_frac,
                                               abs=1e-9)
    assert abs(info.residual - i_ref.residual) <= ATOL
    np.testing.assert_allclose(a.x, a_ref.x, rtol=0, atol=ATOL)


def test_auto_bucket_max_is_the_layouts():
    prob = instances.sparse_cell_instance(num_users=160, num_servers=16,
                                          cells=4, seed=2)[0]
    _, info = engine.solve(prob, device="cpu", max_rounds=2)
    lay = BucketedLayout.from_problem(prob)
    assert info.layout == "bucketed" and info.bucket_max == lay.bucket_max
    _, info = engine.solve(prob, device="cpu", max_rounds=2, layout="dense")
    assert info.layout == "dense" and info.bucket_max == 0
