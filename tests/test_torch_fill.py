"""Parity of the port's ``psdsf_fill`` (plain version on the CPU) with the
JAX reference: the whole-cluster fill against the Pallas kernel in
interpret mode and against the numpy event oracle, one event's outputs
against the Pallas event, and the float32 pin. The CUDA kernel itself is
held against this plain version by tests/test_torch_cuda.py on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gamma_matrix
from repro.core.instances import (cell_cluster_instance,
                                  dense_random_instance, fig1_instance,
                                  fig2_instance)
from repro.kernels.psdsf_fill import kernel as jax_kernel
from repro.kernels.psdsf_fill.ops import fill_cluster_padded
from repro.kernels.psdsf_fill.ref import fill_cluster_ref
from repro_torch.kernels.psdsf_fill import ref as port_ref
from repro_torch.kernels.psdsf_fill.ops import fill_cluster

from conftest import random_problems

ATOL_F64 = 1e-9


@pytest.fixture()
def x64():
    with jax.enable_x64(True):
        yield


def _t(a, dtype=torch.float64, device="cpu"):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _port_fill(prob, g, x_ext, mode, dtype=torch.float64, device="cpu"):
    return fill_cluster(_t(prob.capacities, dtype, device),
                        _t(prob.demands, dtype, device),
                        _t(prob.weights, dtype, device),
                        _t(g, dtype, device), _t(x_ext, dtype, device),
                        mode=mode)


_NAMED = [fig1_instance, fig2_instance, dense_random_instance]
_CASES = [(f.__name__, f) for f in _NAMED] + [
    (f"random{i}", (lambda i=i: random_problems(4, seed=13)[i]))
    for i in range(4)]


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
@pytest.mark.parametrize("name,prob_fn", _CASES, ids=[c[0] for c in _CASES])
def test_fill_cluster_matches_pallas_and_oracle_f64(x64, name, prob_fn, mode):
    prob = prob_fn()
    g = gamma_matrix(prob)
    rng = np.random.default_rng(9)
    x_ext = rng.uniform(0.0, 2.0, (prob.num_users, prob.num_servers))
    got = _port_fill(prob, g, x_ext, mode).numpy()
    pallas = fill_cluster_padded(prob.capacities, prob.demands, prob.weights,
                                 g, x_ext, mode=mode, interpret=True)
    oracle = fill_cluster_ref(prob.capacities, prob.demands, prob.weights, g,
                              x_ext, mode=mode)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL_F64)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL_F64)


def _event_inputs(seed=4):
    """One mid-loop event of the dense pinned instance: some users frozen,
    some resources saturated, nonzero frozen usage and levels."""
    prob = dense_random_instance()
    g = gamma_matrix(prob)
    rng = np.random.default_rng(seed)
    n, k, r = prob.num_users, prob.num_servers, prob.num_resources
    x_ext = rng.uniform(0.0, 2.0, (n, k))
    rate = np.where(g > 0, prob.weights[:, None] * g, 0.0)
    floors = np.where(g > 0, x_ext / np.maximum(rate, 1e-300), 0.0)
    active = (g > 0) & (rng.random((n, k)) > 0.2)
    rate = np.where(active, rate, 0.0)
    floors = np.where(active, floors, 0.0)
    caps = prob.capacities
    frozen = rng.uniform(0.0, 0.3, (k, r)) * caps
    saturated = rng.random((k, r)) < 0.15
    saturated[0] = True                     # a server that cannot bind
    level = rng.uniform(0.0, 0.5, k)
    return floors, rate, prob.demands, caps, frozen, saturated, level


@pytest.mark.parametrize("steps", [48, 5])
def test_fill_event_levels_matches_pallas_f64(x64, steps):
    floors, rate, dem, caps, frozen, sat, level = _event_inputs()
    want = jax_kernel.fill_event_levels(
        jnp.asarray(floors), jnp.asarray(rate), jnp.asarray(dem),
        jnp.asarray(caps), jnp.asarray(frozen), jnp.asarray(sat, jnp.float64),
        jnp.asarray(level), steps=steps, interpret=True)
    got = port_ref.fill_event_levels(
        _t(floors), _t(rate), _t(dem), _t(caps), _t(frozen),
        torch.as_tensor(sat), _t(level), steps=steps)
    for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                            got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0,
                                   atol=ATOL_F64, err_msg=name)


def test_fill_cluster_f32_pin():
    # the reference's own float32 pin (tests/test_kernels_interpret.py):
    # <= 5e-6 * scale on the 256x32 cell instance, 26 bisection steps
    cell, _, _ = cell_cluster_instance(num_users=256, num_servers=32,
                                       cells=4, seed=0)
    g = gamma_matrix(cell)
    rng = np.random.default_rng(2)
    x_ext = rng.uniform(0.0, 2.0, (cell.num_users, cell.num_servers))
    got = _port_fill(cell, g, x_ext, "rdm", dtype=torch.float32)
    assert got.dtype == torch.float32
    want = fill_cluster_ref(cell.capacities, cell.demands, cell.weights, g,
                            x_ext, mode="rdm")
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got.double().numpy() - want).max()) <= 5e-6 * scale


def test_fill_cluster_rejects_unknown_mode():
    prob = fig1_instance()
    g = gamma_matrix(prob)
    with pytest.raises(ValueError, match="mode"):
        _port_fill(prob, g, np.zeros_like(g), "xdm")
