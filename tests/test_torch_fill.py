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


# -- the cluster plan of the Hopper fill kernel, emulated in plain torch ----

from repro_torch.core.instances import sparse_cell_instance  # noqa: E402
from repro_torch.kernels.psdsf_fill import kernel as port_kernel  # noqa: E402


def _cluster_event(floors, rate, dem, caps, frozen, sat, level, *, steps,
                   cluster, cap, step_rows, tk):
    """What ``csrc/psdsf_fill.cu`` computes, pass for pass: the users split
    into ``cluster`` slices of ceil(N / cluster); in each server tile of
    ``tk`` columns a slice keeps, load step by load step of ``step_rows``
    rows, the rows with a nonzero rate in the tile while they fit in
    ``cap``, and streams the rest of the slice from the first step that did
    not fit. Each pass sums every slice's kept rows and streamed rows
    (a partial per slice), the partials are merged in slice order (the
    largest floor by max), and the decisions are the kernel's."""
    n, k = floors.shape
    r = dem.shape[1]
    size = -(-n // cluster)
    parts = []                          # per tile: per slice (rows, rows)
    for t0 in range(0, k, tk):
        live = rate[:, t0:t0 + tk] > 0
        tile = []
        for s in range(cluster):
            r0, r1 = min(n, s * size), min(n, s * size + size)
            kept, stream_from = [], r1
            for s0 in range(r0, r1, step_rows):
                rows = [j for j in range(s0, min(s0 + step_rows, r1))
                        if bool(live[j].any())]
                if len(kept) + len(rows) > cap:
                    stream_from = s0
                    break
                kept += rows
            tile.append((torch.tensor(kept, dtype=torch.long),
                         torch.arange(stream_from, r1)))
        parts.append(tile)

    def sums(fn):
        """(K, ...) merged over the slices in order, per tile."""
        out = []
        for i, t0 in enumerate(range(0, k, tk)):
            cols = slice(t0, t0 + tk)
            tot = None
            for kept, streamed in parts[i]:
                rows = torch.cat([kept, streamed])
                p = fn(rows, cols)
                tot = p if tot is None else tot + p
            out.append(tot)
        return torch.cat(out)

    def usage(pt):
        return sums(lambda rows, cols: (rate[rows, cols] * (
            pt[cols][None, :] - floors[rows, cols]).clamp(min=0.0)).T
            @ dem[rows])

    zero = torch.zeros((), dtype=floors.dtype)
    slope = sums(lambda rows, cols: rate[rows, cols].T @ dem[rows])
    fmax = []
    for i, t0 in enumerate(range(0, k, tk)):
        cols = slice(t0, t0 + tk)
        m = torch.zeros(min(tk, k - t0), dtype=floors.dtype)
        for kept, streamed in parts[i]:
            rows = torch.cat([kept, streamed])
            if len(rows):
                m = torch.maximum(m, torch.where(
                    rate[rows, cols] > 0, floors[rows, cols], zero)
                    .amax(dim=0))
        fmax.append(m)
    hi0 = torch.maximum(torch.cat(fmax), level)
    canb = ~sat & (slope > port_ref.TOL)
    head = (caps - frozen - usage(hi0)).clamp(min=0.0)
    step_up = torch.where(canb, head / slope.clamp(min=port_ref.TOL),
                          torch.full_like(head, port_ref.BIG)).amin(dim=1)
    lo = level
    hi = torch.where(canb.any(dim=1), hi0 + step_up, lo)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        crossed = (canb & (frozen + usage(mid) >= caps)).any(dim=1)
        lo, hi = torch.where(crossed, lo, mid), torch.where(crossed, mid, hi)
    lvl = torch.maximum(hi, level)
    lsl = sums(lambda rows, cols: (rate[rows, cols] * (
        floors[rows, cols] <= lvl[cols][None, :])).T @ dem[rows])
    return lvl, frozen + usage(lvl), lsl, slope


def _check_event(got, want, atol, what):
    for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                            got, want):
        w_ = np.asarray(w_)
        scale = max(float(np.abs(w_).max()), 1.0)
        # the bisection takes the same path: the levels agree far inside
        # the bound, to the ulps of the bracket's end points
        tol = 1e-12 * scale if name == "level" else atol * scale
        np.testing.assert_allclose(g_.numpy(), w_, rtol=0, atol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("cluster,cap,step_rows", [
    (1, 10**9, 256),        # one block per tile, all kept
    (2, 3, 5),              # kept rows overflow mid-slice: the rest streams
    (8, 0, 64),             # nothing kept: every pass streams
    (8, 10**9, 7),          # slices of 8 users, the last of 4
    (4, 2, 1)])
def test_cluster_plan_matches_plain_and_pallas_f64(x64, cluster, cap,
                                                   step_rows):
    floors, rate, dem, caps, frozen, sat, level = _event_inputs()
    args = [_t(floors), _t(rate), _t(dem), _t(caps), _t(frozen),
            torch.as_tensor(sat), _t(level)]
    got = _cluster_event(*args, steps=48, cluster=cluster, cap=cap,
                         step_rows=step_rows, tk=4)
    _check_event(got, port_ref.fill_event_levels(*args, steps=48), ATOL_F64,
                 "plain")
    want = jax_kernel.fill_event_levels(
        jnp.asarray(floors), jnp.asarray(rate), jnp.asarray(dem),
        jnp.asarray(caps), jnp.asarray(frozen), jnp.asarray(sat, jnp.float64),
        jnp.asarray(level), steps=48, interpret=True)
    _check_event(got, want, ATOL_F64, "pallas")


@pytest.mark.parametrize("dtype,steps,tk", [(torch.float64, 48, 4),
                                            (torch.float32, 26, 8)])
def test_cluster_plan_of_the_wrapper_on_a_sparse_cell(dtype, steps, tk):
    # the datacenter pin's structure at 600 x 64: the wrapper's own plan
    # (cluster, cap) and the kernel's load step of 4 rows per user lane
    prob, _ = sparse_cell_instance(num_users=600, num_servers=64, cells=4)
    g = gamma_matrix(prob)
    rng = np.random.default_rng(3)
    n, k = g.shape
    rate = np.where(g > 0, prob.weights[:, None] * g, 0.0)
    floors = np.where(g > 0, rng.uniform(0, 2, (n, k))
                      / np.maximum(rate, 1e-300), 0.0)
    active = (g > 0) & (rng.random((n, k)) > 0.2)
    caps = prob.capacities
    args = [_t(np.where(active, floors, 0.0), dtype),
            _t(np.where(active, rate, 0.0), dtype), _t(prob.demands, dtype),
            _t(caps, dtype), _t(rng.uniform(0, 0.3, caps.shape) * caps, dtype),
            torch.as_tensor(rng.random(caps.shape) < 0.15),
            _t(rng.uniform(0, 0.5, k), dtype)]
    itemsize = torch.finfo(dtype).bits // 8
    assert port_kernel.tile_servers(itemsize) == tk
    cluster, cap = port_kernel.plan(n, k, prob.num_resources, itemsize)
    assert cluster == 8 and cap == -(-n // cluster)      # the slice fits
    want = port_ref.fill_event_levels(*args, steps=steps)
    atol = ATOL_F64 if dtype == torch.float64 else 5e-6
    for cap_ in (cap, 20):                  # resident; partly streamed
        got = _cluster_event(*args, steps=steps, cluster=cluster, cap=cap_,
                             step_rows=4 * 256 // tk, tk=tk)
        for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                                got, want):
            scale = max(float(w_.abs().max()), 1.0)
            assert float((g_ - w_).abs().max()) <= atol * scale, name


@pytest.mark.parametrize("k,itemsize,cells", [(256, 8, 16), (1024, 4, 64)])
def test_fill_plan_keeps_the_main_paths_slices_resident(k, itemsize, cells):
    # chip_smoke's dense main path: 20,000 users on 256 servers in float64
    # and on 1,024 in float32. At least 132 blocks, and every block's rows
    # with an eligible server in its tile fit its shared memory, so each
    # block reads floors and rate from device memory once per event
    prob, _ = sparse_cell_instance(num_users=20000, num_servers=k,
                                   cells=cells)
    n = prob.num_users
    cluster, cap = port_kernel.plan(n, k, prob.num_resources, itemsize)
    tk = port_kernel.tile_servers(itemsize)
    tiles = -(-k // tk)
    assert tiles * cluster >= 132
    row_bytes = (2 * tk + prob.num_resources) * itemsize
    assert cap * row_bytes <= port_kernel.SMEM_KEPT
    elig = prob.eligibility.reshape(n, tiles, tk).any(axis=2)   # (N, tiles)
    size = -(-n // cluster)
    for s in range(cluster):
        most = int(elig[s * size:(s + 1) * size].sum(axis=0).max())
        assert most <= cap, (s, most, cap)
