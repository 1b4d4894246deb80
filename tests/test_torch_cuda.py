"""The port's Hopper kernels against their plain PyTorch versions on a
CUDA card. Every test here is marked ``gpu`` and skips without a card; on
one, run ``python -m pytest -q -m gpu tests/test_torch_cuda.py``. The file
imports neither jax nor ``repro`` (the card's machine has no jax): the plain
versions are held against the JAX reference by the CPU tests in
tests/test_torch_{fill,vds,solve,attention,ssd}.py."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.gamma import gamma_matrix
from repro_torch.core.instances import (dense_random_instance, fig2_instance,
                                       sparse_cell_instance)
from repro_torch.core.layout import BucketedLayout
from repro_torch.kernels.psdsf_fill import kernel as fill_kernel
from repro_torch.kernels.psdsf_fill import ref as fill_ref
from repro_torch.kernels.psdsf_fill.ops import fill_cluster
from repro_torch.kernels.psdsf_fill_bucketed import kernel as bucketed_kernel
from repro_torch.kernels.psdsf_fill_bucketed import ref as bucketed_ref
from repro_torch.kernels.psdsf_vds import kernel as vds_kernel
from repro_torch.kernels.psdsf_vds import ref as vds_ref

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "`python -m pytest -q -m gpu tests/test_torch_cuda.py`")
    return torch.device("cuda")


def _event_inputs(n, k, r, dtype, device, seed=4):
    """One mid-loop fill event: some users frozen, some resources
    saturated (all of server 0), nonzero frozen usage and levels."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 8.0, (n, k)) * (rng.random((n, k)) > 0.3)
    phi = rng.uniform(0.5, 2.0, n)
    rate = np.where(g > 0, phi[:, None] * g, 0.0)
    floors = np.where(g > 0, rng.uniform(0, 2, (n, k)) / np.maximum(
        rate, 1e-300), 0.0)
    active = (g > 0) & (rng.random((n, k)) > 0.2)
    caps = rng.uniform(5.0, 50.0, (k, r))
    sat = rng.random((k, r)) < 0.15
    sat[0] = True
    arrays = [np.where(active, floors, 0.0), np.where(active, rate, 0.0),
              rng.uniform(0.05, 2.0, (n, r)), caps,
              rng.uniform(0.0, 0.3, (k, r)) * caps]
    out = [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]
    out.append(torch.as_tensor(sat, device=device))
    out.append(torch.as_tensor(rng.uniform(0, 0.5, k), dtype=dtype,
                               device=device))
    return out


@pytest.mark.parametrize("n,k,r", [(60, 12, 4), (1, 1, 1), (700, 33, 3),
                                   (5000, 256, 8)])
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9),
                                         (torch.float32, 5e-6)])
def test_fill_kernel_matches_plain(cuda, n, k, r, dtype, bound):
    args = _event_inputs(n, k, r, dtype, cuda)
    steps = 48 if dtype == torch.float64 else 26
    before = fill_kernel.fill_event_levels.launches
    got = fill_kernel.fill_event_levels(*args, steps=steps)
    torch.cuda.synchronize()
    assert fill_kernel.fill_event_levels.launches == before + 1
    want = fill_ref.fill_event_levels(*args, steps=steps)
    for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                            got, want):
        scale = max(float(w_.abs().max()), 1.0)
        assert float((g_ - w_).abs().max()) <= bound * scale, name


def test_fill_kernel_rejects_bad_inputs(cuda):
    args = _event_inputs(8, 4, 2, torch.float64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fill_kernel.fill_event_levels(args[0].T.contiguous().T, *args[1:],
                                      steps=4)
    with pytest.raises(ValueError, match="float64"):
        fill_kernel.fill_event_levels(*args[:2], args[2].float(), *args[3:],
                                      steps=4)


def _close_event(got, want, bound):
    for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                            got, want):
        scale = max(float(w_.abs().max()), 1.0)
        assert float((g_ - w_).abs().max()) <= bound * scale, name


@pytest.mark.parametrize("r", range(1, 9))
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9),
                                         (torch.float32, 5e-6)])
def test_fill_kernel_every_resource_count(cuda, r, dtype, bound):
    # every R case the source instantiates, ragged N and K (K not a
    # multiple of the tile, N not of the cluster)
    args = _event_inputs(333, 37, r, dtype, cuda, seed=r)
    steps = 48 if dtype == torch.float64 else 26
    _close_event(fill_kernel.fill_event_levels(*args, steps=steps),
                 fill_ref.fill_event_levels(*args, steps=steps), bound)


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9),
                                         (torch.float32, 5e-6)])
def test_fill_kernel_one_server_and_all_saturated(cuda, dtype, bound):
    steps = 48 if dtype == torch.float64 else 26
    # K = 1: one tile, one live server
    args = _event_inputs(500, 1, 4, dtype, cuda, seed=5)
    args[5][:] = False
    _close_event(fill_kernel.fill_event_levels(*args, steps=steps),
                 fill_ref.fill_event_levels(*args, steps=steps), bound)
    # every resource saturated: no server can bind, every bracket collapses
    # and the level stays where it was
    args = _event_inputs(400, 20, 3, dtype, cuda, seed=6)
    args[5][:] = True
    got = fill_kernel.fill_event_levels(*args, steps=steps)
    _close_event(got, fill_ref.fill_event_levels(*args, steps=steps), bound)
    assert torch.equal(got[0], args[6])


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9),
                                         (torch.float32, 5e-6)])
def test_fill_kernel_streaming_branch(cuda, monkeypatch, dtype, bound):
    # a dense slice too large for one cluster's shared memory (40,000
    # users of 8 servers, ~56% active): each block keeps the rows that fit
    # and streams the rest every pass; with no room at all (cap 0) it
    # streams its whole slice, here and on a small instance
    args = _event_inputs(40000, 8, 6, dtype, cuda, seed=8)
    steps = 48 if dtype == torch.float64 else 26
    cluster, cap = fill_kernel.plan(40000, 8, 6, args[0].element_size())
    assert cap < -(-40000 // cluster)            # the slice does not fit
    want = fill_ref.fill_event_levels(*args, steps=steps)
    partly = fill_kernel.fill_event_levels(*args, steps=steps)
    monkeypatch.setattr(fill_kernel, "plan", lambda *a: (cluster, 0))
    streamed = fill_kernel.fill_event_levels(*args, steps=steps)
    small = _event_inputs(600, 8, 6, dtype, cuda, seed=8)
    small_streamed = fill_kernel.fill_event_levels(*small, steps=steps)
    torch.cuda.synchronize()
    for got in (partly, streamed):
        _close_event(got, want, bound)
    _close_event(small_streamed, fill_ref.fill_event_levels(
        *small, steps=steps), bound)


def test_fill_kernel_main_path_shape(cuda):
    # chip_smoke's float64 pin shape (20,000 x 256, R = 4, 3% dense): at
    # least 132 blocks, and the kernel agrees with its plain version
    from repro_torch.core.instances import sparse_cell_instance
    prob, _ = sparse_cell_instance()
    g = torch.as_tensor(gamma_matrix(prob), device=cuda)
    n, k = g.shape
    cluster, _ = fill_kernel.plan(n, k, 4, 8)
    assert cluster * -(-k // fill_kernel.tile_servers(8)) >= 132
    rng = np.random.default_rng(1)
    rate = torch.where(g > 0, torch.as_tensor(prob.weights, device=cuda)
                       [:, None] * g, torch.zeros((), device=cuda,
                                                  dtype=g.dtype))
    floors = torch.where(g > 0, torch.as_tensor(
        rng.uniform(0, 2, (n, k)), device=cuda) / rate.clamp(min=1e-300),
        torch.zeros((), device=cuda, dtype=g.dtype))
    caps = torch.as_tensor(prob.capacities, device=cuda)
    args = [floors, rate, torch.as_tensor(prob.demands, device=cuda), caps,
            0.1 * caps, torch.zeros(caps.shape, dtype=torch.bool,
                                    device=cuda),
            torch.zeros(k, dtype=torch.float64, device=cuda)]
    _close_event(fill_kernel.fill_event_levels(*args, steps=48),
                 fill_ref.fill_event_levels(*args, steps=48), 1e-9)


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
def test_fill_cluster_on_card_matches_cpu(cuda, mode):
    prob = dense_random_instance()
    g = gamma_matrix(prob)
    x_ext = np.random.default_rng(9).uniform(0.0, 2.0, g.shape)
    arrays = (prob.capacities, prob.demands, prob.weights, g, x_ext)
    got = fill_cluster(*(torch.as_tensor(a, device=cuda) for a in arrays),
                       mode=mode)
    want = fill_cluster(*(torch.as_tensor(a) for a in arrays), mode=mode)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("n,k", [(96, 24), (300, 130), (1, 1),
                                 (20000, 256)])
def test_vds_kernel_matches_plain(cuda, n, k):
    rng = np.random.default_rng(n)
    xo = torch.as_tensor(rng.uniform(0, 10, n), dtype=torch.float32,
                         device=cuda)
    gamma = rng.uniform(0, 2, (n, k)) * (rng.random((n, k)) > 0.4)
    gamma[:, 0] = 0.0                      # empty column: BIG, row 0
    if n >= 96:
        gamma[[10, 40, 70], min(1, k - 1)] = 4.0   # ties
        xo[[10, 40, 70]] = 0.0
    g = torch.as_tensor(gamma, dtype=torch.float32, device=cuda)
    before = vds_kernel.vds_argmin.launches
    mn, arg = vds_kernel.vds_argmin(xo, g)
    torch.cuda.synchronize()
    assert vds_kernel.vds_argmin.launches == before + 1
    pmn, parg = vds_ref.vds_argmin(xo, g)
    assert torch.equal(arg, parg)
    torch.testing.assert_close(mn, pmn, rtol=1e-6, atol=0)


def _vds_case(n, k, seed=0):
    rng = np.random.default_rng(seed)
    xo = rng.uniform(0, 10, n).astype(np.float32)
    gamma = (rng.uniform(0, 2, (n, k))
             * (rng.random((n, k)) > 0.4)).astype(np.float32)
    gamma[:, 0] = 0.0                      # empty column: BIG, row 0
    return xo, gamma


def _vds_check(xo, g):
    before = vds_kernel.vds_argmin.launches
    mn, arg = vds_kernel.vds_argmin(xo, g)
    torch.cuda.synchronize()
    assert vds_kernel.vds_argmin.launches == before + 1
    pmn, parg = vds_ref.vds_argmin(xo, g)
    assert torch.equal(arg, parg)
    assert torch.equal(mn, pmn)            # IEEE division: the same bits
    return mn, arg


def test_vds_kernel_ties_across_slabs(cuda):
    n, k = 20000, 256
    xo, gamma = _vds_case(n, k)
    rows = vds_kernel.grid(n, k, vds_kernel._sm_count(cuda))["rows"]
    assert rows < n
    # the minimum 0 (a zero numerator) won at both sides of a slab
    # boundary and in a later slab; no other row reaches it
    ties = {1: (rows - 1, rows, 3 * rows), 2: (rows, 5 * rows),
            3: (0, n - 1)}
    tied = sorted({row for rows_ in ties.values() for row in rows_})
    xo[tied] = 0.0
    for col, rows_ in ties.items():
        gamma[tied, col] = 0.0
        gamma[list(rows_), col] = 4.0
    xo_t = torch.as_tensor(xo, device=cuda)
    mn, arg = _vds_check(xo_t, torch.as_tensor(gamma, device=cuda))
    assert arg[:4].tolist() == [0, rows - 1, rows, 0]


@pytest.mark.parametrize("n,k", [(20000, 130), (3000, 255), (50, 7),
                                 (1, 1), (1, 300), (63, 4), (700, 1024)])
def test_vds_kernel_ragged_shapes(cuda, n, k):
    # K % 4 != 0 takes the scalar path; N below one slab (64 rows) writes
    # the outputs from one slab; N = 1
    xo, gamma = _vds_case(n, k, seed=n + k)
    _vds_check(torch.as_tensor(xo, device=cuda),
               torch.as_tensor(gamma, device=cuda))


@pytest.mark.parametrize("n,k", [(20000, 256), (97, 8)])
def test_vds_kernel_unaligned_base(cuda, n, k):
    # gamma one float past a 16-byte boundary: contiguous, not float4-able
    xo, gamma = _vds_case(n, k, seed=3)
    buf = torch.empty(n * k + 1, dtype=torch.float32, device=cuda)
    g = buf[1:].view(n, k)
    g.copy_(torch.as_tensor(gamma))
    assert g.is_contiguous() and g.data_ptr() % 16 != 0
    _vds_check(torch.as_tensor(xo, device=cuda), g)


def test_vds_merge_kernel_alone(cuda):
    n, k = 20000, 256
    xo, gamma = _vds_case(n, k, seed=4)
    xo_t = torch.as_tensor(xo, device=cuda)
    g = torch.as_tensor(gamma, device=cuda)
    rows = vds_kernel.grid(n, k, vds_kernel._sm_count(cuda))["rows"]
    parts = [vds_ref.vds_argmin(xo_t[r0:r0 + rows], g[r0:r0 + rows])
             for r0 in range(0, n, rows)]
    pmin = torch.stack([p[0] for p in parts]).contiguous()
    parg = torch.stack([p[1] + r0 for p, r0 in
                        zip(parts, range(0, n, rows))]).contiguous()
    mn, arg = vds_kernel.merge_slabs(pmin, parg)
    torch.cuda.synchronize()
    pmn, pa = vds_ref.vds_argmin(xo_t, g)
    assert torch.equal(mn, pmn) and torch.equal(arg, pa)


def test_engine_solve_on_card_matches_cpu(cuda):
    prob = fig2_instance()
    kw = dict(fill="bisect", round="jacobi", tol=0.0, max_rounds=40)
    a_gpu, i_gpu = engine.solve(prob, device="cuda", **kw)
    a_cpu, i_cpu = engine.solve(prob, device="cpu", **kw)
    assert i_gpu.rounds == i_cpu.rounds
    np.testing.assert_allclose(a_gpu.x, a_cpu.x, rtol=0, atol=1e-9)


def _bucketed_event_inputs(k, bmax, r, dtype, device, seed=5):
    """One mid-loop bucketed event: ragged buckets (server 1 empty when
    K > 1), padded and frozen slots inert, some resources saturated (all of
    server 0), nonzero frozen usage and levels."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, bmax + 1, k)
    if k > 1:
        counts[1] = 0
    mask = np.arange(bmax)[None, :] < counts[:, None]
    live = mask & (rng.random((k, bmax)) > 0.2)
    rate = np.where(live, rng.uniform(0.5, 8.0, (k, bmax)), 0.0)
    floors = np.where(live, rng.uniform(0.0, 2.0, (k, bmax)), 0.0)
    dem = rng.uniform(0.05, 2.0, (k, bmax, r))
    caps = rng.uniform(5.0, 50.0, (k, r)) * max(1.0, bmax / 40)
    sat = rng.random((k, r)) < 0.15
    sat[0] = True
    arrays = [floors, rate, dem, caps, rng.uniform(0.0, 0.3, (k, r)) * caps]
    out = [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]
    out.append(torch.as_tensor(sat, device=device))
    out.append(torch.as_tensor(rng.uniform(0, 0.5, k), dtype=dtype,
                               device=device))
    return out


@pytest.mark.parametrize("k,bmax,r", [(256, 692, 4), (37, 101, 4),
                                      (33, 130, 1), (5, 1, 4), (1, 1, 1),
                                      (300, 257, 8), (3, 6000, 8)])
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9),
                                         (torch.float32, 5e-6)])
def test_bucketed_kernel_matches_plain(cuda, k, bmax, r, dtype, bound):
    # (3, 6000, 8) does not fit in shared memory and streams from device
    # memory in every pass
    args = _bucketed_event_inputs(k, bmax, r, dtype, cuda)
    steps = 48 if dtype == torch.float64 else 26
    before = bucketed_kernel.fill_event_levels_bucketed.launches
    got = bucketed_kernel.fill_event_levels_bucketed(*args, steps=steps)
    torch.cuda.synchronize()
    assert bucketed_kernel.fill_event_levels_bucketed.launches == before + 1
    want = bucketed_ref.fill_event_levels_bucketed(*args, steps=steps)
    for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                            got, want):
        scale = max(float(w_.abs().max()), 1.0)
        assert float((g_ - w_).abs().max()) <= bound * scale, name
    if k > 1:                               # the empty bucket is a no-op
        assert float(got[0][1]) == float(args[6][1])


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9),
                                         (torch.float32, 5e-6)])
def test_bucketed_kernel_streaming_branch(cuda, monkeypatch, dtype, bound):
    # the same event at the pin's bucket shape held in registers, staged in
    # shared memory and streamed from device memory: bit-identical
    args = _bucketed_event_inputs(64, 692, 4, dtype, cuda)
    steps = 48 if dtype == torch.float64 else 26
    fill = bucketed_kernel.fill_event_levels_bucketed
    assert bucketed_kernel.plan(692, 4, dtype, steps)["path"] == "registers"
    in_registers = fill(*args, steps=steps)
    monkeypatch.setattr(bucketed_kernel, "REG_SLOTS", ())
    staged = fill(*args, steps=steps)
    monkeypatch.setattr(bucketed_kernel, "SMEM_STAGE_MAX", 0)
    streamed = fill(*args, steps=steps)
    want = bucketed_ref.fill_event_levels_bucketed(*args, steps=steps)
    torch.cuda.synchronize()
    for r_, g_, s_, w_ in zip(in_registers, staged, streamed, want):
        assert torch.equal(g_, s_) and torch.equal(r_, s_)
        scale = max(float(w_.abs().max()), 1.0)
        assert float((s_ - w_).abs().max()) <= bound * scale


@pytest.mark.parametrize("steps", ["full", 5])
@pytest.mark.parametrize("r", range(1, 9))
@pytest.mark.parametrize("k,bmax", [(64, 692), (40, 662), (33, 130), (7, 1)])
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9),
                                         (torch.float32, 5e-6)])
def test_bucketed_kernel_plans_agree(cuda, monkeypatch, k, bmax, r, steps,
                                     dtype, bound):
    # every path (registers, shared memory, streamed) gives the same bits:
    # one slot-to-thread map and one reduction order. Bmax 692 is not a
    # multiple of the slots a thread, a float32 row of 662 is not a
    # multiple of 16 bytes, and 5 steps stop the bisection early
    steps = (48 if dtype == torch.float64 else 26) if steps == "full" \
        else steps
    args = _bucketed_event_inputs(k, bmax, r, dtype, cuda, seed=r)
    want = bucketed_ref.fill_event_levels_bucketed(*args, steps=steps)
    fill = bucketed_kernel.fill_event_levels_bucketed
    first = None
    reg_slots = bucketed_kernel.REG_SLOTS
    for reg, smem in ((reg_slots, 220 * 1024), ((), 220 * 1024), ((), 0)):
        monkeypatch.setattr(bucketed_kernel, "REG_SLOTS", reg)
        monkeypatch.setattr(bucketed_kernel, "SMEM_STAGE_MAX", smem)
        got = fill(*args, steps=steps)
        torch.cuda.synchronize()
        for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                                got, want):
            scale = max(float(w_.abs().max()), 1.0)
            assert float((g_ - w_).abs().max()) <= bound * scale, \
                (name, reg, smem)
        if first is None:
            first = got
        assert all(torch.equal(a, b) for a, b in zip(first, got)), \
            (reg, smem)


def test_bucketed_kernel_rejects_bad_inputs(cuda):
    args = _bucketed_event_inputs(8, 16, 2, torch.float64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bucketed_kernel.fill_event_levels_bucketed(
            args[0].T.contiguous().T, *args[1:], steps=4)
    with pytest.raises(ValueError, match="float64"):
        bucketed_kernel.fill_event_levels_bucketed(
            *args[:2], args[2].float(), *args[3:], steps=4)
    with pytest.raises(ValueError, match="resources"):
        bucketed_kernel.fill_event_levels_bucketed(
            *_bucketed_event_inputs(2, 3, 9, torch.float64, cuda), steps=4)


def _sparse_problem():
    prob, _ = sparse_cell_instance(num_users=2000, num_servers=64, cells=8)
    g = gamma_matrix(prob)
    lay = BucketedLayout.from_support(g > 0)
    return prob, g, lay


@pytest.mark.parametrize("mode", ["rdm", "tdm"])
def test_bucketed_solve_kernel_driven_matches_plain_driven(cuda, mode):
    from repro_torch.core.psdsf_torch import _solve_core_bucketed_torch
    from repro_torch.kernels.psdsf_fill_bucketed.ref import \
        fill_cluster_bucketed_plain
    prob, g, lay = _sparse_problem()
    arrays = [torch.as_tensor(a, dtype=torch.float64, device=cuda) for a in
              (prob.demands, prob.capacities, prob.weights, g,
               np.zeros_like(g))]
    idx = torch.as_tensor(lay.indices, device=cuda)
    mask = torch.as_tensor(lay.mask, device=cuda)
    kw = dict(fill="bisect", round_mode="jacobi")
    before = bucketed_kernel.fill_event_levels_bucketed.launches
    x_k, r_k, _ = _solve_core_bucketed_torch(*arrays, idx, mask, mode, 16,
                                             0.0, **kw)
    events = 1 if mode == "tdm" else prob.num_resources + 1
    assert bucketed_kernel.fill_event_levels_bucketed.launches \
        == before + 16 * events
    x_p, r_p, _ = _solve_core_bucketed_torch(
        *arrays, idx, mask, mode, 16, 0.0,
        cluster_fill=fill_cluster_bucketed_plain, **kw)
    assert r_k == r_p == 16
    torch.testing.assert_close(x_k, x_p, rtol=0, atol=1e-9)


def test_engine_auto_on_card_matches_cpu(cuda):
    prob, _, lay = _sparse_problem()
    kw = dict(fill="bisect", round="jacobi", tol=0.0, max_rounds=12)
    a_gpu, i_gpu = engine.solve(prob, device="cuda", **kw)
    a_cpu, i_cpu = engine.solve(prob, device="cpu", **kw)
    assert i_gpu.layout == i_cpu.layout == "bucketed"
    assert i_gpu.bucket_max == lay.bucket_max
    assert i_gpu.rounds == i_cpu.rounds
    np.testing.assert_allclose(a_gpu.x, a_cpu.x, rtol=0, atol=1e-9)


# -- attention kernels (flash for prefill, decode over the cache) ------------

from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ref as decode_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402

#: kernel vs plain: float32 sums in another order (2e-5, the JAX kernel
#: tests' bound); bfloat16 outputs may round one ulp (2^-8) apart (2e-2)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _randn(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (1, 1024, 16, 8, 128), (1, 1000, 16, 8, 128), (2, 77, 4, 2, 16),
    (1, 1, 4, 2, 16), (2, 130, 8, 1, 64), (1, 200, 6, 3, 40),
    (1, 1024, 8, 1, 256), (2, 77, 8, 1, 256),   # gemma_2b: MQA, head dim 256
    (1, 65, 4, 2, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, b, s, hq, hkv, d, dtype, causal):
    q = _randn((b, s, hq, d), dtype, cuda, 1)
    k = _randn((b, s, hkv, d), dtype, cuda, 2)
    v = _randn((b, s, hkv, d), dtype, cuda, 3)
    before = flash_kernel.flash_attention.launches
    got = flash_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = flash_ref.flash_attention(q, k, v, causal=causal)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_reads_strided_layout(cuda):
    # q, k, v as views of one fused (B, S, Hq + 2 Hkv, D) projection
    qkv = _randn((2, 150, 16 + 2 * 8, 128), torch.bfloat16, cuda, 4)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
    got = flash_kernel.flash_attention(q, k, v)
    want = flash_ref.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("b,s_max,hq,hkv,d", [
    (8, 2048, 16, 8, 128), (3, 100, 4, 2, 16), (2, 64, 16, 1, 64),
    (4, 300, 8, 8, 32),
    (8, 2048, 24, 8, 64),      # granite_moe_3b_a800m: groups of 3
    (8, 2048, 48, 8, 128),     # grok_1_314b: groups of 6 (rep > 4)
    (8, 2048, 32, 8, 128),     # jamba_v0_1_52b, granite_3_8b: groups of 4
    (8, 2048, 8, 1, 256),      # gemma_2b: groups of 8 at head dim 256
    (8, 2048, 40, 8, 128),     # qwen2_5_32b: groups of 5
    (8, 2048, 64, 8, 128),     # qwen2_vl_72b: groups of 8
    (8, 2048, 32, 32, 64),     # musicgen_large: MHA
    (3, 100, 16, 1, 256),      # the widest group at the widest head
    (3, 100, 4, 2, 256), (2, 64, 4, 2, 136)])   # two packs a lane
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, b, s_max, hq, hkv, d, dtype):
    q = _randn((b, hq, d), dtype, cuda, 5)
    kc = _randn((b, s_max, hkv, d), dtype, cuda, 6)
    vc = _randn((b, s_max, hkv, d), dtype, cuda, 7)
    # 1, the whole cache, past the cache (clamped), and ragged lengths
    lens = [1, s_max, s_max + 9, s_max // 2 + 3, 65, 64, 2, s_max - 1][:b]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = decode_kernel.decode_attention.launches
    got = decode_kernel.decode_attention(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    assert decode_kernel.decode_attention.launches == before + 1
    want = decode_ref.decode_attention(q, kc, vc, kv_len)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s_max,lens", [
    (1, 32768, [32765]),                   # one long cache: many chunks
    (8, 2048, [1, 2048, 2085, 1027, 513, 64, 1531, 2047]),   # serving
    (6, 1000, [0, 1, "c", "c+1", 1000, 1009]),   # 0, 1, a chunk's end,
    (3, 4096, ["c", "c+1", 4096]),               # S_max and past it
    (2, 64, [64, 70])])                    # one chunk per sequence
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_split_kv_lengths(cuda, b, s_max, lens, dtype):
    # qwen3_1_7b's heads; "c" is the wrapper's own chunk (the rows of one
    # split block), so "c" ends a chunk and "c+1" starts the next
    chunk = decode_kernel.chunk_rows(b, s_max, 8)
    lens = [chunk + (1 if n == "c+1" else 0) if isinstance(n, str) else n
            for n in lens]
    q = _randn((b, 16, 128), dtype, cuda, 12)
    kc = _randn((b, s_max, 8, 128), dtype, cuda, 13)
    vc = _randn((b, s_max, 8, 128), dtype, cuda, 14)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    if s_max >= 2048:
        assert b * 8 * -(-s_max // chunk) > 132
    if s_max <= 64:
        assert chunk >= s_max
    got = decode_kernel.decode_attention(q, kc, vc, kv_len)
    want = decode_ref.decode_attention(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any()


def test_decode_kernel_zero_length_and_strided_cache(cuda):
    # a (B, S_max, Hkv, D) view inside a wider buffer; length 0 gives zeros
    buf = _randn((3, 96, 4, 2 * 64), torch.float32, cuda, 8)
    kc, vc = buf[..., :64], buf[..., 64:]
    q = _randn((3, 8, 64), torch.float32, cuda, 9)
    kv_len = torch.tensor([0, 50, 96], dtype=torch.int32, device=cuda)
    got = decode_kernel.decode_attention(q, kc, vc, kv_len)
    want = decode_ref.decode_attention(q, kc, vc, kv_len)
    assert not got[0].any()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    # one element in: rows not 16-byte aligned take element-wise loads
    buf1 = _randn((3, 96, 4, 2 * 64 + 2), torch.float32, cuda, 10)
    kc1, vc1 = buf1[..., 1:65], buf1[..., 65:129]
    got = decode_kernel.decode_attention(q, kc1, vc1, kv_len)
    want = decode_ref.decode_attention(q, kc1, vc1, kv_len)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,s_max,hq,hkv,d", [
    (8, 2048, 16, 8, 128), (3, 100, 4, 2, 16), (2, 64, 16, 1, 64),
    (3, 100, 16, 1, 256), (8, 2048, 48, 8, 128), (2, 64, 4, 2, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_lse_matches_plain(cuda, b, s_max, hq, hkv, d, dtype):
    # the heads' log-sum-exps (natural log) beside the output; -inf and
    # zeros at length 0
    q = _randn((b, hq, d), dtype, cuda, 15)
    kc = _randn((b, s_max, hkv, d), dtype, cuda, 16)
    vc = _randn((b, s_max, hkv, d), dtype, cuda, 17)
    lens = [0, s_max, s_max // 2 + 3, 1, 65, 64, 2, s_max - 1][:b]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = decode_kernel.decode_attention.launches
    got, lse = decode_kernel.decode_attention(q, kc, vc, kv_len,
                                              return_lse=True)
    torch.cuda.synchronize()
    assert decode_kernel.decode_attention.launches == before + 1
    assert lse.shape == (b, hq) and lse.dtype == torch.float32
    assert lse.is_contiguous()
    want, want_lse = decode_ref.decode_attention(q, kc, vc, kv_len,
                                                 return_lse=True)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    assert torch.isneginf(lse[0]).all() and not got[0].any()
    # the output is the same launch's without the log-sum-exps
    assert torch.equal(decode_kernel.decode_attention(q, kc, vc, kv_len),
                       got)


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_kv_decode_runs_the_kernel_on_each_chunk(cuda, n_chunks,
                                                       dtype):
    # what each device of a sequence-sharded cache runs, on one card: the
    # row write and the decode kernel on its chunk, then the merge by
    # log-sum-exps; equal to one decode over the whole cache
    from repro_torch.models.attention import (_decode_chunk_torch,
                                              _decode_rows_torch,
                                              merge_chunks_torch)
    b, s_max, hq, hkv, d = 8, 2048, 16, 8, 128
    q = _randn((b, 1, hq, d), dtype, cuda, 18)
    k_new = _randn((b, 1, hkv, d), dtype, cuda, 19)
    v_new = _randn((b, 1, hkv, d), dtype, cuda, 20)
    kc = _randn((b, s_max, hkv, d), dtype, cuda, 21)
    vc = _randn((b, s_max, hkv, d), dtype, cuda, 22)
    # the first row, chunk edges, the last row and past the cache
    pos = torch.tensor([0, 511, 512, 1023, 1024, 1500, 2047, 2050],
                       device=cuda)
    want_k, want_v = kc.clone(), vc.clone()
    want = _decode_rows_torch(q, k_new, v_new, want_k, want_v, pos)
    chunk = s_max // n_chunks
    before = decode_kernel.decode_attention.launches
    parts = [_decode_chunk_torch(q, k_new, v_new, kc[:, c0:c0 + chunk],
                                 vc[:, c0:c0 + chunk], pos, c0, s_max)
             for c0 in range(0, s_max, chunk)]
    got = merge_chunks_torch(torch.cat([o for o, _ in parts]),
                             torch.cat([lse for _, lse in parts])).to(dtype)
    torch.cuda.synchronize()
    assert decode_kernel.decode_attention.launches == before + n_chunks
    assert torch.equal(kc, want_k) and torch.equal(vc, want_v)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_attention_kernels_reject_bad_inputs(cuda):
    q = _randn((1, 64, 4, 16), torch.float32, cuda, 0)
    k = _randn((1, 64, 2, 16), torch.float32, cuda, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_kernel.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous head dim"):
        flash_kernel.flash_attention(q, k.transpose(2, 3).contiguous()
                                     .transpose(2, 3), k)
    with pytest.raises(ValueError, match="on"):
        flash_kernel.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_kernel.flash_attention(q[..., :12], k[..., :12], k[..., :12])
    with pytest.raises(ValueError, match="multiple of"):
        flash_kernel.flash_attention(q[:, :, :3], k, k)
    qd = q[:, 0]
    kv_len = torch.tensor([5], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decode_kernel.decode_attention(qd.double(), k.double(), k.double(),
                                       kv_len)
    with pytest.raises(ValueError, match="kv_len"):
        decode_kernel.decode_attention(qd, k, k, kv_len.long())
    with pytest.raises(ValueError, match="kv_len"):
        decode_kernel.decode_attention(qd, k, k, kv_len.cpu())
    with pytest.raises(ValueError, match="contiguous head dim"):
        decode_kernel.decode_attention(
            qd, k.transpose(2, 3).contiguous().transpose(2, 3), k, kv_len)
    with pytest.raises(ValueError, match="at most 16"):
        decode_kernel.decode_attention(
            _randn((1, 32, 16), torch.float32, cuda, 0), k[:, :, :1],
            k[:, :, :1], kv_len)


def test_serving_engine_on_card_matches_cpu(cuda):
    # the smoke config in float32: the engine's tokens on the card (through
    # both kernels) equal those of the plain versions on the CPU
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServingEngine
    cfg = get_smoke_config("qwen3_1_7b")
    params = init_params(cfg, 0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params=params.to(dev), max_slots=3,
                            max_len=24, tenant_weights={"gold": 2.0},
                            device=dev)
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit("gold" if i % 3 else "free",
                       [int(t) for t in rng.integers(0, cfg.vocab_size, 9)],
                       max_new_tokens=5)
        before = (flash_kernel.flash_attention.launches,
                  decode_kernel.decode_attention.launches)
        done = eng.run(max_steps=40)
        after = (flash_kernel.flash_attention.launches,
                 decode_kernel.decode_attention.launches)
        out[dev] = [(r.rid, r.out_tokens) for r in done]
        launched = (after[0] - before[0], after[1] - before[1])
        if dev == "cpu":
            assert launched == (0, 0)
        else:
            assert launched == (cfg.num_layers * len(done),
                                cfg.num_layers * eng._steps)
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("s", [1024, 1000, 128, 1])
@pytest.mark.parametrize("hq,hkv,d", [(24, 8, 64), (48, 8, 128),
                                      (32, 8, 128)])
def test_flash_kernel_moe_widths_take_the_hopper_body(cuda, s, hq, hkv, d):
    # granite (groups of 3, head_dim 64), grok (6) and jamba (4) in bf16:
    # every call takes the Hopper (TMA + wgmma) body
    q = _randn((1, s, hq, d), torch.bfloat16, cuda, 21)
    k = _randn((1, s, hkv, d), torch.bfloat16, cuda, 22)
    v = _randn((1, s, hkv, d), torch.bfloat16, cuda, 23)
    before = flash_kernel.flash_attention.hopper_launches
    got = flash_kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.hopper_launches == before + 1
    want = flash_ref.flash_attention(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "grok_1_314b",
                                  "jamba_v0_1_52b"])
def test_moe_serving_engine_on_card_matches_cpu(cuda, arch):
    # the MoE smoke configs in float32: the engine's tokens on the card
    # (the attention kernels, jamba's ssd_scan, the MoE layer's gathers and
    # batched products) equal those of the plain versions on the CPU
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServingEngine
    cfg = get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params=params.to(dev), max_slots=3,
                            max_len=24, tenant_weights={"gold": 2.0},
                            device=dev)
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit("gold" if i % 3 else "free",
                       [int(t) for t in rng.integers(0, cfg.vocab_size, 9)],
                       max_new_tokens=5)
        out[dev] = [(r.rid, r.out_tokens) for r in eng.run(max_steps=40)]
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("t", [1024, 1000, 8])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "grok_1_314b"])
def test_moe_gather_matches_dense_on_card(cuda, arch, t):
    # the full widths in float32: the gather routing against the dense
    # GShard baseline on the same params and tokens, at groups of 256, 8
    # and one decode step's 8 tokens (grok's expert width of 32,768 cut to
    # 4,096 to keep its float32 expert stacks small)
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch, dtype="float32", param_dtype="float32")
    if arch == "grok_1_314b":
        cfg = dataclasses.replace(cfg, moe_d_ff=4096)
    gen = torch.Generator(device=cuda).manual_seed(0)
    layer = moe.MoE(cfg, gen, torch.float32, cuda)
    x = torch.randn(1, t, cfg.d_model, generator=gen, device=cuda)
    y_g, aux_g = moe.moe_apply_gather_torch(cfg, layer, x)
    y_d, aux_d = moe.moe_apply_dense_torch(cfg, layer, x)
    scale = max(1.0, float(y_d.abs().max()))
    assert float((y_g - y_d).abs().max()) <= 1e-4 * scale
    assert abs(float(aux_g) - float(aux_d)) <= 1e-6


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_bf16_tensor_core_and_fallback_paths(cuda, causal):
    # bf16 with head_dim 128 and 16-byte-aligned rows takes the tensor-core
    # body; the same values one element into a wider buffer (rows no
    # longer 16-byte aligned) take the CUDA-core body: both match plain
    s, hq, hkv, d = 333, 16, 8, 128
    buf = _randn((3, 1, s, hq, d + 1), torch.bfloat16, cuda, 11)
    aligned = [t[..., :d].contiguous() for t in
               (buf[0], buf[1, :, :, :hkv], buf[2, :, :, :hkv])]
    shifted = [buf[0, ..., 1:], buf[1, :, :, :hkv, 1:], buf[2, :, :, :hkv, 1:]]
    for t, u in zip(aligned, shifted):
        u.copy_(t)
    want = flash_ref.flash_attention(*aligned, causal=causal).float()
    for args in (aligned, shifted):
        got = flash_kernel.flash_attention(*args, causal=causal)
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


# -- the SSD scan (Mamba-2 prefill) -------------------------------------------

from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402

#: kernel vs plain (float32 on the same inputs), times max(1, max|plain|):
#: float32 sums in another order (1e-4, the JAX ssd tests' bound); a
#: bfloat16 y is rounded once more (2^-9 relative), bound 2^-8; the final
#: state is float32 in both (1e-4)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -8}


def _ssd_inputs(b, h, s, p, n, dtype, device, seed, init=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, s, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, h, s, generator=g)) / 2
    a = -torch.exp(torch.randn(h, generator=g) * 0.3)
    bm = torch.randn(b, s, n, generator=g) / 2
    cm = torch.randn(b, s, n, generator=g) / 2
    st0 = torch.randn(b, h, p, n, generator=g) if init else None
    out = [x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype), st0]
    return [None if t is None else t.to(device) for t in out]


def _ssd_close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    bound = tol * max(1.0, float(want.abs().max()))
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("b,h,s,p,n,chunk,init", [
    (1, 64, 1024, 64, 128, 128, False),   # mamba2_1_3b's prefill shape
    (1, 64, 1000, 64, 128, 128, False),   # ragged S
    (1, 4, 5, 64, 128, 128, True),        # S < chunk
    (2, 3, 100, 16, 16, 16, True),        # the smoke widths, one P block
    (2, 3, 200, 40, 24, 128, True),       # P split 32 + 8, odd N
    (1, 2, 77, 96, 32, 16, False),        # P split in three
    (1, 128, 1024, 64, 16, 64, False),    # jamba_v0_1_52b's prefill shape
    (1, 128, 1000, 64, 16, 64, False),    # ragged S
    (2, 3, 100, 16, 16, 64, True),        # chunk 64 at the smoke widths
    (1, 4, 40, 64, 8, 64, True)])         # S < chunk, N below one tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(cuda, b, h, s, p, n, chunk, init, dtype):
    x, dt, a, bm, cm, st0 = _ssd_inputs(b, h, s, p, n, dtype, cuda, s,
                                        init)
    before = ssd_kernel.ssd_scan.launches
    y, state = ssd_kernel.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                   init_state=st0)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_scan.launches == before + 1
    assert y.shape == x.shape and y.dtype == dtype
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    want_y, want_state = ssd_ref.ssd_scan(x.float(), dt, a, bm.float(),
                                          cm.float(), chunk=chunk,
                                          init_state=st0)
    _ssd_close(y, want_y, SSD_TOL[dtype], "y")
    _ssd_close(state, want_state, SSD_TOL[torch.float32], "final state")


def test_ssd_ops_reads_the_model_layout(cuda):
    # x, B and C as slices of one (B, S, d_inner + 2 N) conv output, x
    # viewed (B, S, H, P) and dt (B, S, H): the layer's own strides
    b, s, h, p, n = 2, 150, 6, 32, 64
    g = torch.Generator().manual_seed(12)
    xbc = torch.randn(b, s, h * p + 2 * n, generator=g).to(cuda,
                                                           torch.bfloat16)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.rand(b, s, h, generator=g).to(cuda) / 2
    a = -torch.rand(h, generator=g).to(cuda) - 0.5
    y, state = ssd_ops.ssd_chunked(x, dt, a, bm, cm, chunk=16)
    assert y.shape == (b, s, h, p) and y.is_contiguous()
    want_y, want_state = ssd_ref.ssd_scan(
        x.transpose(1, 2).float(), dt.transpose(1, 2), a, bm.float(),
        cm.float(), chunk=16)
    _ssd_close(y.transpose(1, 2), want_y, SSD_TOL[torch.bfloat16], "y")
    _ssd_close(state, want_state, SSD_TOL[torch.float32], "final state")


def test_ssd_kernel_rejects_bad_inputs(cuda):
    x, dt, a, bm, cm, _ = _ssd_inputs(1, 2, 40, 16, 16, torch.float32, cuda,
                                      0)
    with pytest.raises(ValueError, match="chunks of"):
        ssd_kernel.ssd_scan(x, dt, a, bm, cm, chunk=24)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_kernel.ssd_scan(x.double(), dt, a, bm.double(), cm.double())
    with pytest.raises(ValueError, match="dt is"):
        ssd_kernel.ssd_scan(x, dt.bfloat16(), a, bm, cm)
    with pytest.raises(ValueError, match="c_mat is"):
        ssd_kernel.ssd_scan(x, dt, a, bm, cm.cpu())
    with pytest.raises(ValueError, match="state width"):
        big = torch.zeros(1, 40, 129, device=cuda)
        ssd_kernel.ssd_scan(x, dt, a, big, big)
    with pytest.raises(ValueError, match="init_state"):
        ssd_kernel.ssd_scan(x, dt, a, bm, cm, init_state=torch.zeros(
            1, 2, 16, 16, device=cuda).transpose(2, 3))


def test_mamba_serving_engine_on_card_matches_cpu(cuda):
    # the mamba2 smoke config in float32: the engine's tokens on the card
    # (prefill through ssd_scan) equal those of the plain version on the
    # CPU, prompts of 1 to 9 tokens
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServingEngine
    cfg = get_smoke_config("mamba2_1_3b")
    params = init_params(cfg, 0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params=params.to(dev), max_slots=3,
                            max_len=24, tenant_weights={"gold": 2.0},
                            device=dev)
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit("gold" if i % 3 else "free",
                       [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                     1 + 2 * i)],
                       max_new_tokens=5)
        before = ssd_kernel.ssd_scan.launches
        done = eng.run(max_steps=40)
        launched = ssd_kernel.ssd_scan.launches - before
        out[dev] = [(r.rid, r.out_tokens) for r in done]
        assert launched == (0 if dev == "cpu"
                            else cfg.num_layers * len(done))
    assert out["cuda"] == out["cpu"]


# -- the Hopper flash body (TMA + wgmma) and the chunk-parallel SSD ----------

def _flash_counts():
    fa = flash_kernel.flash_attention
    return fa.launches, fa.hopper_launches, fa.tf32_launches, \
        fa.cuda_core_launches


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 1000])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_hopper_body_edges(cuda, monkeypatch, s, d):
    # both block sizes, GQA 1:1, 2:1 and 4:1, causal or not, at the
    # warpgroups' and kv tiles' edges and a ragged 1,000: each call takes
    # the Hopper body
    for bq in flash_kernel.BLOCK_ROWS:
        monkeypatch.setattr(flash_kernel, "block_rows",
                            lambda b, s_, h, _bq=bq: _bq)
        for rep in (1, 2, 4):
            q = _randn((1, s, 2 * rep, d), torch.bfloat16, cuda, s + rep)
            k = _randn((1, s, 2, d), torch.bfloat16, cuda, s + 2 * rep)
            v = _randn((1, s, 2, d), torch.bfloat16, cuda, s + 3 * rep)
            for causal in (True, False):
                before = _flash_counts()
                got = flash_kernel.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                assert _flash_counts() == (before[0] + 1, before[1] + 1,
                                           before[2], before[3])
                want = flash_ref.flash_attention(q, k, v, causal=causal)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=2e-2, atol=2e-2)


def test_flash_hopper_body_model_layout(cuda):
    # q, k, v as views of one fused (B, S, Hq + 2 Hkv, D) projection at
    # qwen3_1_7b's heads: TMA reads the strides, nothing is copied
    qkv = _randn((2, 300, 16 + 2 * 8, 128), torch.bfloat16, cuda, 21)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
    before = _flash_counts()
    got = flash_kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _flash_counts()[1] == before[1] + 1
    want = flash_ref.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("case", ["float32", "unaligned", "head_dim_32",
                                  "head_dim_64", "float32_unaligned"])
def test_flash_body_is_chosen_by_input(cuda, case):
    # aligned float32 at 64 takes the float32 tensor-core body, aligned
    # bf16 at 64 the Hopper one; rows off 16 bytes (either dtype) and head
    # dims other than 64, 128 and 256 take the CUDA-core body
    s, d = 200, 32 if case == "head_dim_32" else 64
    dtype = torch.float32 if case.startswith("float32") else torch.bfloat16
    buf = _randn((3, 1, s, 4, d + 8), dtype, cuda, 22)
    lo = 1 if case.endswith("unaligned") else 0
    q, k, v = (buf[i, :, :, :(4 if i == 0 else 2), lo:lo + d]
               for i in range(3))
    before = _flash_counts()
    got = flash_kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    hopper, tf32 = case == "head_dim_64", case == "float32"
    assert _flash_counts() == (before[0] + 1, before[1] + hopper,
                               before[2] + tf32,
                               before[3] + (not hopper and not tf32))
    want = flash_ref.flash_attention(q, k, v)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,s,p,n,chunk,init", [
    (1, 3, 0, 64, 128, 128, True),        # no rows: the state passes through
    (1, 2, 129, 130, 7, 128, True),       # P in three tiles, odd N
    (2, 4, 1024, 64, 128, 128, True),     # B 2 at mamba2's widths
    (1, 3, 17, 64, 128, 16, False),       # ragged at chunk 16
    (2, 2, 16, 64, 24, 16, True),         # one full chunk of 16
    (1, 5, 127, 40, 128, 128, False)])    # S one short of a chunk
def test_ssd_bf16_chunked_body_edges(cuda, b, h, s, p, n, chunk, init):
    x, dt, a, bm, cm, st0 = _ssd_inputs(b, h, s, p, n, torch.bfloat16, cuda,
                                        s + n, init)
    before = ssd_kernel.ssd_scan.launches
    y, state = ssd_kernel.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                   init_state=st0)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_scan.launches == before + 1
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    if s == 0:
        assert torch.equal(state, st0)
        return
    want_y, want_state = ssd_ref.ssd_scan(x.float(), dt, a, bm.float(),
                                          cm.float(), chunk=chunk,
                                          init_state=st0)
    _ssd_close(y, want_y, SSD_TOL[torch.bfloat16], "y")
    _ssd_close(state, want_state, SSD_TOL[torch.float32], "final state")


@pytest.mark.parametrize("offset", [0, 1])
def test_ssd_bf16_model_layout_at_prefill_width(cuda, offset):
    # ops.ssd_chunked on slices of one conv output at mamba2_1_3b's widths
    # (64 heads x 64, N 128, chunk 128), S 512: 16-byte rows take the
    # cp.async staging; one element in, the element-wise staging
    s, h, p, n = 512, 64, 64, 128
    g = torch.Generator().manual_seed(23)
    xbc = torch.randn(1, s, offset + h * p + 2 * n, generator=g)
    xbc[..., offset + h * p:] /= 2
    xbc = xbc.to(cuda, torch.bfloat16)[..., offset:]
    x = xbc[..., :h * p].reshape(1, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.randn(1, s, h, generator=g)).to(cuda) / 2
    a = -torch.exp(torch.randn(h, generator=g) * 0.3).to(cuda)
    y, state = ssd_ops.ssd_chunked(x, dt, a, bm, cm, chunk=128)
    want_y, want_state = ssd_ref.ssd_scan(
        x.transpose(1, 2).float(), dt.transpose(1, 2), a, bm.float(),
        cm.float(), chunk=128)
    _ssd_close(y.transpose(1, 2), want_y, SSD_TOL[torch.bfloat16], "y")
    _ssd_close(state, want_state, SSD_TOL[torch.float32], "final state")


# -- the allocator's consumers: churn loop, tick layer, batched re-solve ----

#: a float32 path on the card vs the same path on the CPU: each fill event
#: agrees to a few float32 ulps, and the damped sweep carries that forward
#: without amplifying it (chip_smoke.py's PATH_F32_REL)
PATH_F32_REL = 1e-4


def _churn_stream():
    from repro_torch.sched import ChurnEvent
    return [ChurnEvent(1.0, "departure", user=10),
            ChurnEvent(2.0, "departure", user=20),
            ChurnEvent(3.0, "arrival", user=1),
            ChurnEvent(4.0, "degrade", server=2, scale=0.5),
            ChurnEvent(5.0, "restore", server=2)]


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
def test_churn_stream_on_card_matches_cpu(cuda, layout):
    # an arrival outside the layout rebuilds it; every record launches the
    # VDS kernel once and every Jacobi round one fill kernel an event
    from repro_torch.sched import ChurnSimulator
    prob, _ = sparse_cell_instance(num_users=300, num_servers=64,
                                   density=0.05, cells=8, multi_frac=0.2,
                                   seed=4)
    active = np.ones(prob.num_users, dtype=bool)
    active[:3] = False
    counter = (bucketed_kernel.fill_event_levels_bucketed
               if layout == "bucketed" else fill_kernel.fill_event_levels)
    runs = {}
    for device in ("cuda", "cpu"):
        sim = ChurnSimulator(prob, initial_active=active.copy(),
                             layout=layout, fill="bisect", round="jacobi",
                             max_rounds=24, tol=0.0, device=device)
        before = (counter.launches, vds_kernel.vds_argmin.launches)
        recs = [sim.step([], 0.0)] + sim.run(_churn_stream())
        launched = (counter.launches - before[0],
                    vds_kernel.vds_argmin.launches - before[1])
        runs[device] = (sim, recs, launched)
    (gpu, r_gpu, l_gpu), (cpu, r_cpu, l_cpu) = runs["cuda"], runs["cpu"]
    assert l_gpu == (5 * sum(r.rounds for r in r_gpu), len(r_gpu))
    assert l_cpu == (0, 0)
    assert [r.rounds for r in r_gpu] == [r.rounds for r in r_cpu]
    assert [r.bottleneck_server for r in r_gpu] \
        == [r.bottleneck_server for r in r_cpu]
    assert [r.layout_rebuilds for r in r_gpu] \
        == [r.layout_rebuilds for r in r_cpu]
    scale = max(1.0, float(np.abs(cpu.x).max()))
    np.testing.assert_allclose(gpu.x, cpu.x, rtol=0,
                               atol=PATH_F32_REL * scale)
    for a, b in zip(r_gpu, r_cpu):
        assert abs(a.min_vds - b.min_vds) <= PATH_F32_REL * abs(b.min_vds)


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
def test_tick_on_card_matches_cpu(cuda, layout):
    # float64 ticks: the card and the CPU sum in other orders only
    from repro_torch.core.dynamic import DistributedPSDSF
    prob, _, _ = _sparse_problem()
    sims = [DistributedPSDSF(prob, precision="highest", fill="bisect",
                             layout=layout, device=d) for d in ("cuda", "cpu")]
    before = vds_kernel.vds_argmin.launches
    out = []
    for sim in sims:
        sim.tick()
        sim.set_active(5, False)
        sim.tick(servers=np.nonzero(sim.gamma[5] > 0)[0])
        sim.tick(shuffle=True)
        out.append(sim.min_vds())
    assert vds_kernel.vds_argmin.launches == before + 1
    np.testing.assert_allclose(sims[0].x, sims[1].x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    # an argmin may differ only on a tie: the card's pick attains the
    # CPU's minimum
    arg = out[0][1]
    xo = sims[1].x.sum(axis=1) / prob.weights
    picked = xo[arg] / sims[1].gamma[arg, np.arange(len(arg))]
    assert np.all(picked <= out[1][0] * (1 + 1e-6))


def test_batched_resolve_on_card_matches_cpu(cuda):
    from repro_torch.core.batched import batch_problems, psdsf_resolve_batched
    from repro_torch.core.types import AllocationProblem
    prob, g, lay = _sparse_problem()
    probs = []
    for s in (0, 5):
        caps = prob.capacities.copy()
        caps[s] *= 0.5
        probs.append(AllocationProblem(prob.demands, caps, prob.weights,
                                       prob.eligibility))
    srv = np.array([[0, 1, 2, 2], [5, 6, 7, 8]], dtype=np.int32)
    buckets = (np.stack([lay.indices] * 2), np.stack([lay.mask] * 2))
    kw = dict(max_rounds=8, tol=0.0, fill="bisect", round="jacobi",
              layout="bucketed", buckets=buckets)
    outs = {}
    for device in ("cuda", "cpu"):
        bat = batch_problems(probs, dtype=np.float64, device=device)
        arrays = [bat[k] for k in ("demands", "capacities", "weights",
                                   "gamma")]
        before = bucketed_kernel.fill_event_levels_bucketed.launches
        outs[device] = psdsf_resolve_batched(
            *arrays, np.zeros((2,) + g.shape), srv, device=device, **kw)
        launched = bucketed_kernel.fill_event_levels_bucketed.launches \
            - before
        rounds = int(outs[device][1].sum() + outs[device][2].sum())
        assert launched == (5 * rounds if device == "cuda" else 0)
    (x_g, rr_g, rf_g, _), (x_c, rr_c, rf_c, _) = outs["cuda"], outs["cpu"]
    assert rr_g.tolist() == rr_c.tolist() and rf_g.tolist() == rf_c.tolist()
    np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=0,
                               atol=1e-9)


# -- headroom placement and the baselines ----------------------------------

def _patch_plain(monkeypatch):
    """Every allocator kernel's wrapper swapped for its plain version where
    the ops modules call it (chip_smoke.py's ``plain_versions``)."""
    from repro_torch.kernels.psdsf_fill import ops as fill_ops
    from repro_torch.kernels.psdsf_fill_bucketed import ops as b_ops
    from repro_torch.kernels.psdsf_vds import ops as vds_ops
    monkeypatch.setattr(fill_ops, "fill_event_levels",
                        fill_ref.fill_event_levels)
    monkeypatch.setattr(b_ops, "fill_event_levels_bucketed",
                        bucketed_ref.fill_event_levels_bucketed)
    monkeypatch.setattr(vds_ops, "vds_argmin", vds_ref.vds_argmin)


def _launches():
    return (fill_kernel.fill_event_levels.launches,
            bucketed_kernel.fill_event_levels_bucketed.launches,
            vds_kernel.vds_argmin.launches)


@pytest.mark.parametrize("mechanism", ["psdsf-rdm", "psdsf-tdm"])
def test_headroom_solve_on_card_matches_plain(cuda, monkeypatch, mechanism):
    # the level solve and every refill through psdsf_fill; the same solve
    # with the plain versions patched in launches nothing and agrees
    prob, _, _ = _sparse_problem()
    kw = dict(placement="headroom", fill="bisect", round="jacobi",
              layout="dense", max_rounds=24, tol=0.0)
    before = _launches()
    alloc, info = engine.solve(prob, mechanism, device="cuda", **kw)
    assert _launches()[0] > before[0] and _launches()[1:] == before[1:]
    cpu, cpu_info = engine.solve(prob, mechanism, device="cpu", **kw)
    _patch_plain(monkeypatch)
    before = _launches()
    plain, p_info = engine.solve(prob, mechanism, device="cuda", **kw)
    assert _launches() == before
    for other, o_info in ((plain, p_info), (cpu, cpu_info)):
        np.testing.assert_allclose(alloc.x, other.x, rtol=0, atol=1e-9)
        assert info.rounds == o_info.rounds
    usage = np.einsum("nk,nr->kr", alloc.x, prob.demands)
    assert (usage - prob.capacities).max() <= 1e-9 * prob.capacities.max()


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("mechanism", ["tsf", "cdrf", "cdrfh"])
def test_baseline_solve_on_card_matches_plain(cuda, monkeypatch, mechanism,
                                              layout):
    prob, _, _ = _sparse_problem()
    kw = dict(fill="bisect", round="jacobi", layout=layout, max_rounds=16,
              tol=0.0)
    which = 0 if layout == "dense" else 1
    before = _launches()
    alloc, info = engine.solve(prob, mechanism, device="cuda", **kw)
    launched = [a - b for a, b in zip(_launches(), before)]
    assert launched[which] == 5 * info.rounds and sum(launched) == \
        launched[which]
    _patch_plain(monkeypatch)
    plain, p_info = engine.solve(prob, mechanism, device="cuda", **kw)
    np.testing.assert_allclose(alloc.x, plain.x, rtol=0, atol=1e-9)
    assert info.rounds == p_info.rounds and info.layout == layout


@pytest.mark.parametrize("mechanism", ["tsf", "cdrf", "cdrfh"])
def test_routed_fill_on_card_matches_cpu(cuda, mechanism):
    prob, _, _ = _sparse_problem()
    before = _launches()
    a_gpu, i_gpu = engine.solve(prob, mechanism, placement="headroom",
                                device="cuda")
    assert _launches() == before                  # no kernel in it
    a_cpu, i_cpu = engine.solve(prob, mechanism, placement="headroom",
                                device="cpu")
    np.testing.assert_allclose(a_gpu.x, a_cpu.x, rtol=0, atol=1e-9)
    assert i_gpu.rounds == i_cpu.rounds


def test_baseline_churn_on_card_matches_plain(cuda, monkeypatch):
    # tsf in float32 on the buckets: one bucketed launch an event of every
    # Jacobi round, one VDS launch a record; the plain-driven stream on the
    # card agrees to PATH_F32_REL with equal rounds
    from repro_torch.sched import ChurnSimulator
    prob, _ = sparse_cell_instance(num_users=300, num_servers=64,
                                   density=0.05, cells=8, multi_frac=0.2,
                                   seed=4)
    kw = dict(mechanism="tsf", layout="bucketed", fill="bisect",
              round="jacobi", max_rounds=24, tol=0.0, device="cuda")
    runs = []
    for plain in (False, True):
        if plain:
            _patch_plain(monkeypatch)
        sim = ChurnSimulator(prob, **kw)
        before = _launches()
        recs = [sim.step([], 0.0)] + sim.run(_churn_stream())
        runs.append((sim, recs, [a - b for a, b in
                                 zip(_launches(), before)]))
    (sim, recs, launched), (p_sim, p_recs, p_launched) = runs
    assert launched == [0, 5 * sum(r.rounds for r in recs), len(recs)]
    assert p_launched == [0, 0, 0]
    assert [r.rounds for r in recs] == [r.rounds for r in p_recs]
    scale = max(1.0, float(np.abs(p_sim.x).max()))
    np.testing.assert_allclose(sim.x, p_sim.x, rtol=0,
                               atol=PATH_F32_REL * scale)
    for a, b in zip(recs, p_recs):
        assert abs(a.min_vds - b.min_vds) <= PATH_F32_REL * abs(b.min_vds)


# -- the host lexmm router and the scheduler layers --------------------------

def _card_fleet(seed=0, num_pods=24, num_jobs=200):
    """A seeded fleet of pods over four generations and jobs with
    allow-lists, HBM floors and DCN needs (a sparse eligibility)."""
    from repro_torch.sched import Cluster, TenantJob, TPUPod
    rng = np.random.default_rng(seed)
    gens = ("v4", "v5e", "v5p", "v6e")
    pods = [TPUPod(f"pod{i}", gens[i % 4], int(rng.choice([32, 64, 128])),
                   float(rng.choice([16.0, 32.0, 95.0])),
                   float(rng.uniform(64, 512)), float(rng.uniform(100, 800)),
                   float(rng.choice([0.0, 25.0])))
            for i in range(num_pods)]
    jobs = [TenantJob(f"job{j}", float(rng.uniform(0.5, 2.0)),
                      float(rng.choice([4, 8])), float(rng.uniform(20, 200)),
                      float(rng.uniform(4, 16)), float(rng.uniform(10, 40)),
                      float(rng.choice([0.0, 1.0])),
                      min_hbm_per_chip=float(rng.choice([0.0, 20.0])),
                      generations=(gens[j % 4],),
                      needs_dcn=bool(rng.random() < 0.2))
            for j in range(num_jobs)]
    return Cluster(pods), jobs


@pytest.mark.parametrize("layout", ["dense", "bucketed"])
def test_schedule_detail_on_card_matches_plain(cuda, monkeypatch, layout):
    # five resources: six launches of the layout's fill kernel a Jacobi
    # round; the plain-driven solve on the card launches nothing and agrees
    from repro_torch.sched import schedule_detail
    fleet, jobs = _card_fleet()
    kw = dict(fill="bisect", round="jacobi", layout=layout, max_rounds=24,
              tol=0.0, device="cuda")
    which = 0 if layout == "dense" else 1
    before = _launches()
    alloc, info = schedule_detail(fleet, jobs, **kw)
    launched = [a - b for a, b in zip(_launches(), before)]
    assert launched[which] == 6 * info.rounds == sum(launched)
    assert info.layout == layout
    _patch_plain(monkeypatch)
    before = _launches()
    plain, p_info = schedule_detail(fleet, jobs, **kw)
    assert _launches() == before
    np.testing.assert_allclose(alloc.x, plain.x, rtol=0, atol=1e-9)
    assert info.rounds == p_info.rounds
    cpu, _ = schedule_detail(fleet, jobs, **dict(kw, device="cpu"))
    np.testing.assert_allclose(alloc.x, cpu.x, rtol=0, atol=1e-9)


def test_lexmm_churn_vds_on_card_matches_plain(cuda, monkeypatch):
    # the router runs on the host; each record's telemetry is one VDS
    # launch on the card, held against the plain-driven stream
    from repro_torch.sched import ChurnSimulator, poisson_churn_events
    prob, _ = sparse_cell_instance(num_users=200, num_servers=16,
                                   density=0.1, cells=4, seed=4)
    events = poisson_churn_events(prob.num_users, prob.num_servers,
                                  horizon=4, arrival_rate=3.0,
                                  departure_rate=3.0, degrade_rate=0.5,
                                  seed=2)
    runs = []
    for plain in (False, True):
        if plain:
            _patch_plain(monkeypatch)
        sim = ChurnSimulator(prob, mechanism="tsf", placement="lexmm",
                             device="cuda")
        before = _launches()
        recs = [sim.step([], 0.0)] + sim.run(events)
        runs.append((sim, recs, [a - b for a, b in
                                 zip(_launches(), before)]))
    (sim, recs, launched), (p_sim, p_recs, p_launched) = runs
    assert launched == [0, 0, len(recs)] and p_launched == [0, 0, 0]
    for a, b in zip(recs, p_recs):
        assert (a.rounds, a.lp_calls, a.warm_hits, a.warm_fallbacks,
                a.router_mode) == (b.rounds, b.lp_calls, b.warm_hits,
                                   b.warm_fallbacks, b.router_mode)
        assert abs(a.min_vds - b.min_vds) <= PATH_F32_REL * abs(b.min_vds)
    np.testing.assert_allclose(sim.x, p_sim.x, rtol=0, atol=1e-9)
    assert {r.router_mode for r in recs} >= {"warm"}


# -- head dim 256 (gemma_2b) and the five dense and frontend configs --------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_head_dim_256_takes_the_cuda_core_body(cuda, dtype):
    # gemma_2b's 8 query heads on one kv head at head dim 256, causal,
    # ragged S: float32 takes the float32 tensor-core body (32-row kv
    # tiles), bfloat16 the Hopper body (64-row kv stages); the CUDA-core
    # body neither
    q = _randn((1, 333, 8, 256), dtype, cuda, 31)
    k = _randn((1, 333, 1, 256), dtype, cuda, 32)
    v = _randn((1, 333, 1, 256), dtype, cuda, 33)
    before = _flash_counts()
    got = flash_kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    hopper = dtype == torch.bfloat16
    assert _flash_counts() == (before[0] + 1, before[1] + hopper,
                               before[2] + (not hopper), before[3])
    want = flash_ref.flash_attention(q.float(), k.float(), v.float())
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


def test_attention_kernels_reject_past_their_limits(cuda):
    # head dim 264 (past 256) and a group of 17 query heads (past 16)
    # raise on the card; nothing falls back to the plain version
    q = _randn((1, 16, 2, 264), torch.bfloat16, cuda, 0)
    k = _randn((1, 16, 1, 264), torch.bfloat16, cuda, 0)
    with pytest.raises(ValueError, match="up to 256"):
        flash_kernel.flash_attention(q, k, k)
    kv_len = torch.tensor([5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="up to 256"):
        decode_kernel.decode_attention(q[:, 0], k, k, kv_len)
    q17 = _randn((1, 17, 64), torch.bfloat16, cuda, 0)
    k1 = _randn((1, 16, 1, 64), torch.bfloat16, cuda, 0)
    with pytest.raises(ValueError, match="at most 16"):
        decode_kernel.decode_attention(q17, k1, k1, kv_len)


def test_gemma_prefill_takes_the_cuda_core_body(cuda):
    # one full-width gemma_2b layer in bf16: its prefill's flash launch
    # runs the Hopper body at head dim 256 (no longer the CUDA-core body),
    # its decode step the decode kernel's tensor-core body (8 query heads
    # on one kv head)
    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    cfg = get_config("gemma_2b", num_layers=1)
    params = tmodel.init_params(cfg, 0, device=cuda)
    before = _flash_counts()
    logits, caches = tmodel.forward_prefill(cfg, params, [[3] * 70],
                                            device=cuda)
    torch.cuda.synchronize()
    assert _flash_counts() == (before[0] + 1, before[1] + 1, before[2],
                               before[3])
    assert caches[0]["k"].shape == (1, 70, 1, 256)
    assert bool(torch.isfinite(logits).all())
    tc = decode_kernel.decode_attention.tc_launches
    step, _ = tmodel.forward_decode(cfg, params, tmodel.init_caches(
        cfg, 2, 80, device=cuda), [1, 2], 70, device=cuda)
    torch.cuda.synchronize()
    assert decode_kernel.decode_attention.tc_launches == tc + 1
    assert bool(torch.isfinite(step).all())


@pytest.mark.parametrize("arch", ["qwen2_5_32b", "granite_3_8b", "gemma_2b",
                                  "qwen2_vl_72b", "musicgen_large"])
def test_dense_and_frontend_engines_on_card_match_cpu(cuda, arch):
    # the smoke configs in float32 (qkv bias, untied embeddings, GeGLU at
    # MQA, M-RoPE, the GELU MLP): the engine's tokens on the card through
    # both attention kernels equal those of the plain versions on the CPU
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServingEngine
    cfg = get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params=params.to(dev), max_slots=3,
                            max_len=24, tenant_weights={"gold": 2.0},
                            device=dev)
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit("gold" if i % 3 else "free",
                       [int(t) for t in rng.integers(0, cfg.vocab_size, 9)],
                       max_new_tokens=5)
        before = (flash_kernel.flash_attention.launches,
                  decode_kernel.decode_attention.launches)
        done = eng.run(max_steps=40)
        launched = (flash_kernel.flash_attention.launches - before[0],
                    decode_kernel.decode_attention.launches - before[1])
        out[dev] = [(r.rid, r.out_tokens) for r in done]
        assert launched == ((0, 0) if dev == "cpu" else
                            (cfg.num_layers * len(done),
                             cfg.num_layers * eng._steps))
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("arch", ["qwen2_vl_72b", "musicgen_large"])
def test_frontend_stub_prefill_on_card_matches_cpu(cuda, arch):
    # the first 6 positions from precomputed embeddings; qwen2_vl_72b's
    # get 3-D M-RoPE positions over a 2 x 3 patch grid, the text after it
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import forward_prefill, init_params
    cfg = get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 11), generator=g)
    extra = torch.randn(2, 11, cfg.d_model, generator=g)
    mask = torch.zeros(2, 11, dtype=torch.bool)
    mask[:, :6] = True
    pos = torch.arange(11).expand(2, 11)
    if cfg.rope_type == "mrope":
        grid = torch.arange(6)
        t = torch.cat([torch.zeros(6, dtype=torch.long), torch.arange(3, 8)])
        h = torch.cat([grid // 3, torch.arange(3, 8)])
        w = torch.cat([grid % 3, torch.arange(3, 8)])
        pos = torch.stack([t, h, w])[:, None].expand(3, 2, 11)
    want, _ = forward_prefill(cfg, params, tokens, pos, extra, mask,
                              device="cpu")
    got, _ = forward_prefill(cfg, params.to(cuda), tokens, pos, extra, mask,
                             device=cuda)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# -- the training slice: flash's log-sum-exp, _FlashTrain and _SsdTrain ----

def _lse_counts():
    fa = flash_kernel.flash_attention
    return fa.launches, fa.hopper_launches, fa.tf32_launches, \
        fa.cuda_core_launches, fa.lse_launches


@pytest.mark.parametrize("s", [1, 65, 200, 1000])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_plain(cuda, s, d, dtype, causal):
    # each row's log-sum-exp from both tensor-core bodies (bf16: the
    # Hopper body; float32: the split-TF32 body), ragged S and GQA 2:1;
    # lse is float32 in both runs:
    # 1e-5 in float32, 1e-3 in bfloat16 (the scores are products of the
    # same bf16 inputs summed in float32)
    q = _randn((2, s, 4, d), dtype, cuda, 31)
    k = _randn((2, s, 2, d), dtype, cuda, 32)
    v = _randn((2, s, 2, d), dtype, cuda, 33)
    before = _lse_counts()
    out, lse = flash_kernel.flash_attention(q, k, v, causal=causal,
                                            return_lse=True)
    torch.cuda.synchronize()
    hopper = dtype == torch.bfloat16 and d in flash_kernel.HOPPER_HEAD_DIMS
    tf32 = dtype == torch.float32 and d in flash_kernel.TF32_HEAD_DIMS
    assert _lse_counts() == (before[0] + 1, before[1] + hopper,
                             before[2] + tf32,
                             before[3] + (not hopper and not tf32),
                             before[4] + 1)
    assert lse.shape == (2, 4, s) and lse.dtype == torch.float32
    want_out, want_lse = flash_ref.flash_attention(q, k, v, causal=causal,
                                                   return_lse=True)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=tol)
    torch.testing.assert_close(out.float(), want_out.float(),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    # the serving call (no lse) writes the same output
    assert torch.equal(flash_kernel.flash_attention(q, k, v, causal=causal),
                       out)
    assert _lse_counts()[4] == before[4] + 1


def _plain_ssd_train(x, dt, a, b_mat, c_mat, *, chunk):
    y, _ = ssd_ref.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), a, b_mat,
                            c_mat, chunk=chunk)
    return y.transpose(1, 2)


def _train_grads(cfg, params, batch, device):
    params.requires_grad_(True)
    for p in params.parameters():
        p.grad = None
    from repro_torch.models.model import forward_train_torch
    loss, metrics = forward_train_torch(cfg, params, batch, device=device)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {n: p.grad.clone() for n, p in
                         params.named_parameters()}


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mamba2_1_3b"])
def test_train_grads_through_kernels_match_plain(cuda, monkeypatch, arch):
    # a 2-layer float32 model: the loss and every gradient with the
    # kernels (_FlashTrain's flash forward with lse; _SsdTrain's ssd_scan
    # forward) against the same step with the plain versions, 1e-4 x
    # max|.| (float32 sums in another order); the kernels run twice a
    # layer (remat="full" recomputes each layer in the backward)
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_smoke_config(arch), attn_flash_block=16)
    params = init_params(cfg, 3, device="cpu").to(cuda)
    g = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    fa, ssd = flash_kernel.flash_attention, ssd_kernel.ssd_scan
    before = (fa.lse_launches, ssd.launches)
    loss, grads = _train_grads(cfg, params, batch, cuda)
    n_attn = 2 if cfg.has_mixer("attn") else 0
    assert (fa.lse_launches - before[0], ssd.launches - before[1]) == (
        2 * n_attn, 2 * (2 - n_attn))
    monkeypatch.setattr(attention_mod, "flash_attention",
                        flash_ref.flash_attention)
    monkeypatch.setattr(ssm_mod, "ssd_chunked_train", _plain_ssd_train)
    before = (fa.launches, ssd.launches)
    want_loss, want = _train_grads(cfg, params, batch, cuda)
    assert (fa.launches, ssd.launches) == before
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    for name, w in want.items():
        err = float((grads[name] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mamba2_1_3b"])
def test_bf16_train_step_on_card_is_finite(cuda, arch):
    # one bfloat16 step of a 2-layer model, two microbatches: attention at
    # head dim 64 takes flash's Hopper body with lse (2 layers x 2
    # microbatches x 2 with the recompute), mamba the bf16 ssd_scan
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.train import (OptimizerConfig, build_train_step_torch,
                                   make_train_state_torch)
    cfg = dataclasses.replace(
        get_smoke_config(arch), dtype="bfloat16", param_dtype="bfloat16",
        attn_flash_block=64)
    if cfg.has_mixer("attn"):
        cfg = dataclasses.replace(cfg, d_model=256, num_heads=4,
                                  num_kv_heads=2, head_dim=64)
    params = init_params(cfg, 4, device=cuda)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=1)
    state = make_train_state_torch(cfg, params, oc, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (4, 256),
                           generator=torch.Generator().manual_seed(9))
    counts = (*_lse_counts(), ssd_kernel.ssd_scan.launches)
    state, metrics = build_train_step_torch(cfg, oc, 2, device=cuda)(
        state, {"tokens": tokens, "labels": tokens.roll(-1, 1)})
    torch.cuda.synchronize()
    now = (*_lse_counts(), ssd_kernel.ssd_scan.launches)
    launched = [a - b for a, b in zip(now, counts)]
    if cfg.has_mixer("attn"):
        assert launched == [8, 8, 0, 0, 8, 0]
    else:
        assert launched == [0, 0, 0, 0, 0, 8]
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0
    assert abs(float(metrics["loss"]) - np.log(cfg.vocab_size)) < 2
    for n, p in state["params"].named_parameters():
        # mamba's A_log, D and dt_bias are float32 in any model
        assert p.dtype == before[n].dtype and bool(torch.isfinite(p).all())
    assert any(not torch.equal(p, before[n])
               for n, p in state["params"].named_parameters())
    assert state["opt"]["mu"]["embed"].dtype == torch.float32


# -- sliding window (flash) and float8 caches with first rows (decode) -------

def _window_counts():
    fa = flash_kernel.flash_attention
    return (fa.launches, fa.hopper_launches, fa.tf32_launches,
            fa.cuda_core_launches, fa.window_launches)


@pytest.mark.parametrize("s,window", [(1000, 1), (1000, 48), (1000, 128),
                                      (1000, 129), (1000, 600), (1000, 1000),
                                      (200, 1000)])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 128)])
def test_flash_window_matches_plain(cuda, monkeypatch, s, window, dtype, d):
    # both block sizes of the Hopper body (bf16 at head dims 64, 128 and
    # 256), the float32 tensor-core body (float32 at 128), windows of one
    # key, inside, on and across the kv tiles, past S; out and lse against
    # the plain version; each call counted on its body and as windowed
    hopper = dtype == torch.bfloat16 and d in flash_kernel.HOPPER_HEAD_DIMS
    q = _randn((1, s, 8, d), dtype, cuda, s + window)
    k = _randn((1, s, 4, d), dtype, cuda, s + window + 1)
    v = _randn((1, s, 4, d), dtype, cuda, s + window + 2)
    want, want_lse = flash_ref.flash_attention(q.float(), k.float(),
                                               v.float(), window=window,
                                               return_lse=True)
    tol = ATTN_TOL[dtype]
    for bq in flash_kernel.BLOCK_ROWS if hopper else (64,):
        monkeypatch.setattr(flash_kernel, "block_rows",
                            lambda b, s_, h, _bq=bq: _bq)
        for lse in (False, True):
            before = _window_counts()
            got = flash_kernel.flash_attention(q, k, v, window=window,
                                               return_lse=lse)
            torch.cuda.synchronize()
            assert _window_counts() == (before[0] + 1, before[1] + hopper,
                                        before[2] + (not hopper), before[3],
                                        before[4] + 1)
            out = got[0] if lse else got
            torch.testing.assert_close(out.float(), want, rtol=tol,
                                       atol=tol)
            if lse:
                torch.testing.assert_close(got[1], want_lse, rtol=0,
                                           atol=1e-3)


@pytest.mark.parametrize("hq,hkv", [(16, 8), (32, 8)])
def test_flash_window_long_prompt(cuda, hq, hkv):
    # qwen3_1_7b's and Mistral-7B-v0.1's heads at S 8,192 with its published
    # window of 4,096, on the Hopper body
    s, d, window = 8192, 128, 4096
    q = _randn((1, s, hq, d), torch.bfloat16, cuda, 40)
    k = _randn((1, s, hkv, d), torch.bfloat16, cuda, 41)
    v = _randn((1, s, hkv, d), torch.bfloat16, cuda, 42)
    before = _window_counts()
    got = flash_kernel.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert _window_counts() == (before[0] + 1, before[1] + 1, before[2],
                                before[3], before[4] + 1)
    want = flash_ref.flash_attention(q.float(), k.float(), v.float(),
                                     window=window)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


FP8_CACHES = (torch.float8_e4m3fn, torch.float8_e5m2)


@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 128), (40, 8, 128),
                                      (8, 1, 256), (4, 4, 64), (32, 8, 128),
                                      (4, 2, 136)])
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cache", [None, *FP8_CACHES])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_decode_fp8_and_first_rows_match_plain(cuda, monkeypatch, hq, hkv, d,
                                               qdt, cache, n_chunks):
    # q in bf16 or f32 over a cache of its dtype or float8; first rows 0,
    # inside the length, on a chunk edge, past whole chunks, equal to the
    # length (no row: zeros, lse -inf) and past it; 1, 2 and 4 chunks a
    # sequence; out and lse against the plain version on the same bytes
    b, s_max = 8, 512
    chunk = s_max // n_chunks
    monkeypatch.setattr(decode_kernel, "chunk_rows", lambda *a: chunk)
    q = _randn((b, hq, d), qdt, cuda, 30)
    kc = _randn((b, s_max, hkv, d), qdt, cuda, 31)
    vc = _randn((b, s_max, hkv, d), qdt, cuda, 32)
    if cache is not None:
        kc, vc = kc.to(cache), vc.to(cache)
    lens = torch.tensor([512, 300, 300, 512, 200, 200, 511, 1],
                        dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 17, chunk, 2 * chunk + 3, 200, 260, 510, 0],
                          dtype=torch.int32, device=cuda)
    before = (decode_kernel.decode_attention.launches,
              decode_kernel.decode_attention.window_launches,
              decode_kernel.decode_attention.fp8_launches)
    got, lse = decode_kernel.decode_attention(q, kc, vc, lens,
                                              kv_start=starts,
                                              return_lse=True)
    torch.cuda.synchronize()
    assert (decode_kernel.decode_attention.launches,
            decode_kernel.decode_attention.window_launches,
            decode_kernel.decode_attention.fp8_launches) == (
        before[0] + 1, before[1] + 1, before[2] + (cache is not None))
    want, want_lse = decode_ref.decode_attention(
        q.float(), kc.float(), vc.float(), lens, kv_start=starts,
        return_lse=True)
    tol = ATTN_TOL[qdt]
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    empty = starts >= lens
    assert not got[empty].any() and torch.isneginf(lse[empty]).all()
    # without first rows: the rows [0, len) of the same cache
    plain = decode_ref.decode_attention(q.float(), kc.float(), vc.float(),
                                        lens)
    torch.testing.assert_close(
        decode_kernel.decode_attention(q, kc, vc, lens).float(), plain,
        rtol=tol, atol=tol)


def test_decode_refuses_other_dtype_mixes(cuda):
    q = _randn((1, 4, 16), torch.bfloat16, cuda, 0)
    k = _randn((1, 8, 2, 16), torch.bfloat16, cuda, 1)
    n = torch.tensor([5], dtype=torch.int32, device=cuda)
    for kc, vc in ((k.half(), k.half()), (k.float(), k.float()),
                   (k.to(torch.float8_e4m3fn), k.to(torch.float8_e5m2)),
                   (k.to(torch.float8_e4m3fn), k)):
        with pytest.raises(TypeError, match="float8"):
            decode_kernel.decode_attention(q, kc, vc, n)
    with pytest.raises(ValueError, match="kv_start"):
        decode_kernel.decode_attention(q, k, k, n, kv_start=n.long())


def test_windowed_fp8_serving_engine_on_card_matches_cpu(cuda):
    # the smoke config in float32 with a window of 4 and an e4m3 cache:
    # the tokens on the card (through both kernels' windowed and float8
    # entries) equal those of the plain versions on the CPU
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServingEngine
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              sliding_window=4, cache_dtype="float8_e4m3fn")
    params = init_params(cfg, 0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params=params.to(dev), max_slots=3,
                            max_len=16, tenant_weights={"gold": 2.0},
                            device=dev)
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit("gold" if i % 3 else "free",
                       [int(t) for t in rng.integers(0, cfg.vocab_size, 7)],
                       max_new_tokens=5)
        fa, da = flash_kernel.flash_attention, decode_kernel.decode_attention
        before = (fa.window_launches, da.window_launches, da.fp8_launches)
        done = eng.run(max_steps=40)
        launched = tuple(a - b for a, b in zip(
            (fa.window_launches, da.window_launches, da.fp8_launches),
            before))
        out[dev] = [(r.rid, r.out_tokens) for r in done]
        assert eng.caches[0]["k"].dtype == torch.float8_e4m3fn
        if dev == "cuda":
            steps = cfg.num_layers * eng._steps
            assert launched == (cfg.num_layers * len(done), steps, steps)
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 128), (40, 8, 128),
                                      (8, 1, 256), (4, 4, 64), (4, 2, 136)])
@pytest.mark.parametrize("n_chunks", [1, 4])
def test_decode_f32_q_over_bf16_cache_matches_plain(cuda, monkeypatch, hq,
                                                    hkv, d, n_chunks):
    # a float32 q over bfloat16 caches (float32 params over bfloat16
    # activations): the mixed entry, with and without first rows and the
    # lse, against the plain version on the same bytes at the float32
    # entry's bound, and counted in mixed_launches
    b, s_max = 8, 512
    monkeypatch.setattr(decode_kernel, "chunk_rows",
                        lambda *a: s_max // n_chunks)
    q = _randn((b, hq, d), torch.float32, cuda, 40)
    kc = _randn((b, s_max, hkv, d), torch.bfloat16, cuda, 41)
    vc = _randn((b, s_max, hkv, d), torch.bfloat16, cuda, 42)
    lens = torch.tensor([512, 300, 300, 512, 200, 200, 511, 1],
                        dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 17, 128, 259, 200, 260, 510, 0],
                          dtype=torch.int32, device=cuda)
    da = decode_kernel.decode_attention
    before = (da.launches, da.mixed_launches, da.fp8_launches)
    got, lse = da(q, kc, vc, lens, kv_start=starts, return_lse=True)
    got_all = da(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert (da.launches, da.mixed_launches, da.fp8_launches) == (
        before[0] + 2, before[1] + 2, before[2])
    assert got.dtype == torch.float32 and lse.dtype == torch.float32
    want, want_lse = decode_ref.decode_attention(q, kc, vc, lens,
                                                 kv_start=starts,
                                                 return_lse=True)
    tol = ATTN_TOL[torch.float32]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    torch.testing.assert_close(
        got_all, decode_ref.decode_attention(q, kc, vc, lens), rtol=tol,
        atol=tol)


def test_split_dtype_serving_engine_on_card_matches_cpu(cuda):
    # the smoke config at head dim 64 with float32 params over bfloat16
    # activations: every decode launch takes the mixed entry, every
    # prefill flash the float32 tensor-core body, and the tokens equal the
    # plain versions' on the CPU
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServingEngine
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              param_dtype="float32", dtype="bfloat16",
                              d_model=256, num_heads=4, num_kv_heads=2,
                              head_dim=64)
    params = init_params(cfg, 0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params=params.to(dev), max_slots=3,
                            max_len=16, tenant_weights={"gold": 2.0},
                            device=dev)
        rng = np.random.default_rng(1)
        for i in range(6):
            eng.submit("gold" if i % 3 else "free",
                       [int(t) for t in rng.integers(0, cfg.vocab_size, 7)],
                       max_new_tokens=5)
        fa, da = flash_kernel.flash_attention, decode_kernel.decode_attention
        before = (fa.launches, fa.tf32_launches, da.launches,
                  da.mixed_launches)
        done = eng.run(max_steps=40)
        launched = tuple(a - b for a, b in zip(
            (fa.launches, fa.tf32_launches, da.launches,
             da.mixed_launches), before))
        out[dev] = [(r.rid, r.out_tokens) for r in done]
        assert eng.caches[0]["k"].dtype == torch.bfloat16
        if dev == "cuda":
            prefills = cfg.num_layers * len(done)
            steps = cfg.num_layers * eng._steps
            assert launched == (prefills, prefills, steps, steps)
    assert out["cuda"] == out["cpu"]


# -- head dim 256 on the Hopper flash body, grouped decode on the tensor
# cores ---------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 333, 1000])
@pytest.mark.parametrize("hq,hkv", [(8, 1), (2, 1), (4, 4)])
def test_flash_d256_hopper_body_matches_plain(cuda, s, hq, hkv):
    # gemma_2b's 8:1 group, 2:1 and MHA at head dim 256, at the 64-row kv
    # stages' and the block's edges and ragged; causal or not, with and
    # without the lse; each call on the Hopper body
    q = _randn((1, s, hq, 256), torch.bfloat16, cuda, s + hq)
    k = _randn((1, s, hkv, 256), torch.bfloat16, cuda, s + hq + 1)
    v = _randn((1, s, hkv, 256), torch.bfloat16, cuda, s + hq + 2)
    for causal in (True, False):
        want, want_lse = flash_ref.flash_attention(
            q.float(), k.float(), v.float(), causal=causal, return_lse=True)
        for lse in (False, True):
            before = _lse_counts()
            got = flash_kernel.flash_attention(q, k, v, causal=causal,
                                               return_lse=lse)
            torch.cuda.synchronize()
            assert _lse_counts() == (before[0] + 1, before[1] + 1,
                                     before[2], before[3], before[4] + lse)
            out = got[0] if lse else got
            torch.testing.assert_close(out.float(), want, rtol=2e-2,
                                       atol=2e-2)
            if lse:
                torch.testing.assert_close(got[1], want_lse, rtol=0,
                                           atol=1e-3)


@pytest.mark.parametrize("window", [1, 40, 64, 256, 700])
def test_flash_d256_hopper_body_window_and_layout(cuda, window):
    # two sequences of 1,000 rows as views of one fused (B, S, Hq + 2 Hkv,
    # D) projection at gemma_2b's heads, windows of one key, inside a
    # stage, one stage, four and past S: the Hopper body, each call counted
    # as windowed
    qkv = _randn((2, 1000, 8 + 2, 256), torch.bfloat16, cuda, window)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:9], qkv[:, :, 9:]
    want, want_lse = flash_ref.flash_attention(
        q.float(), k.float(), v.float(), window=window, return_lse=True)
    before = _window_counts()
    got, lse = flash_kernel.flash_attention(q, k, v, window=window,
                                            return_lse=True)
    torch.cuda.synchronize()
    assert _window_counts() == (before[0] + 1, before[1] + 1, before[2],
                                before[3], before[4] + 1)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


def _tc_counts():
    da = decode_kernel.decode_attention
    return da.launches, da.tc_launches, da.fp8_launches, da.window_launches


@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 128), (24, 8, 64),
                                      (40, 8, 128), (48, 8, 128),
                                      (64, 8, 128), (8, 1, 256),
                                      (16, 1, 64), (32, 2, 256)])
@pytest.mark.parametrize("cache", [None, *FP8_CACHES])
@pytest.mark.parametrize("n_chunks", [1, 4])
def test_decode_tc_body_matches_plain(cuda, monkeypatch, hq, hkv, d, cache,
                                      n_chunks):
    # groups of 2, 3, 5, 6, 8 (qwen3_1_7b's, granite_moe's, qwen2_5_32b's,
    # grok's, qwen2_vl_72b's and gemma's widths) and 16, over bf16 and
    # float8 caches; lengths 0, 1, a warp
    # step's and a chunk's edges, the whole cache and past it; with and
    # without first rows (0, inside a step, on a chunk's edge, equal to the
    # length); 1 and 4 chunks a sequence; out and lse against the plain
    # version on the same bytes; every call on the tensor-core body
    b, s_max = 8, 512
    chunk = s_max // n_chunks
    monkeypatch.setattr(decode_kernel, "chunk_rows", lambda *a: chunk)
    q = _randn((b, hq, d), torch.bfloat16, cuda, 50)
    kc = _randn((b, s_max, hkv, d), torch.bfloat16, cuda, 51)
    vc = _randn((b, s_max, hkv, d), torch.bfloat16, cuda, 52)
    if cache is not None:
        kc, vc = kc.to(cache), vc.to(cache)
    lens = torch.tensor([0, 1, 16, chunk, chunk + 1, 333, 512, 600],
                        dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 0, 5, chunk - 1, chunk, 40, 17, 0],
                          dtype=torch.int32, device=cuda)
    for first in (None, starts):
        before = _tc_counts()
        got, lse = decode_kernel.decode_attention(q, kc, vc, lens,
                                                  kv_start=first,
                                                  return_lse=True)
        torch.cuda.synchronize()
        assert _tc_counts() == (before[0] + 1, before[1] + 1,
                                before[2] + (cache is not None),
                                before[3] + (first is not None))
        want, want_lse = decode_ref.decode_attention(
            q.float(), kc.float(), vc.float(), lens, kv_start=first,
            return_lse=True)
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
        empty = (lens <= 0) if first is None else (first >= lens)
        assert not got[empty].any() and torch.isneginf(lse[empty]).all()


@pytest.mark.parametrize("case", ["group_1", "float32", "head_dim_96",
                                  "unaligned", "strided"])
def test_decode_tc_body_is_chosen_by_input(cuda, case):
    # groups of 1, a float32 q, head dim 96 and cache rows off 16 bytes
    # take the CUDA-core body; a bf16 group of 5 on a strided cache view
    # whose rows stay 16-byte chunks the tensor-core body; each held
    # against the plain version
    hq, d, dtype = (2 if case == "group_1" else 10,
                    96 if case == "head_dim_96" else 128,
                    torch.float32 if case == "float32" else torch.bfloat16)
    buf = _randn((2, 300, 3, d + 8), dtype, cuda, 60)
    lo = 4 if case == "unaligned" else 0
    hi = 3 if case == "strided" else 2
    kc, vc = buf[:, :, hi - 2:hi, lo:lo + d], buf[:, :, 1:3, lo:lo + d]
    q = _randn((2, hq, d), dtype, cuda, 61)
    lens = torch.tensor([300, 77], dtype=torch.int32, device=cuda)
    before = _tc_counts()
    got = decode_kernel.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    tc = case == "strided"
    assert _tc_counts()[:2] == (before[0] + 1, before[1] + tc)
    want = decode_ref.decode_attention(q.float(), kc.float(), vc.float(),
                                       lens)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


# -- the float32 bodies on the tensor cores: flash in split TF32, ssd_scan's
# float32 entry on the chunked body ------------------------------------------

@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 129, 333, 1000])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_tf32_body_matches_plain(cuda, s, d):
    # GQA 1:1, 2:1 and 4:1 at the blocks' and kv tiles' edges and ragged;
    # causal or not, with and without the lse, at the float32 bounds
    # (2e-5; lse 1e-5); each call on the float32 tensor-core body
    for rep in (1, 2, 4):
        q = _randn((2, s, 2 * rep, d), torch.float32, cuda, s + rep)
        k = _randn((2, s, 2, d), torch.float32, cuda, s + 2 * rep)
        v = _randn((2, s, 2, d), torch.float32, cuda, s + 3 * rep)
        for causal in (True, False):
            want, want_lse = flash_ref.flash_attention(
                q, k, v, causal=causal, return_lse=True)
            for lse in (False, True):
                before = _lse_counts()
                got = flash_kernel.flash_attention(q, k, v, causal=causal,
                                                   return_lse=lse)
                torch.cuda.synchronize()
                assert _lse_counts() == (before[0] + 1, before[1],
                                         before[2] + 1, before[3],
                                         before[4] + lse)
                out = got[0] if lse else got
                torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
                if lse:
                    torch.testing.assert_close(got[1], want_lse, rtol=0,
                                               atol=1e-5)


@pytest.mark.parametrize("window", [1, 40, 64, 256, 700])
def test_flash_tf32_body_window_and_layout(cuda, window):
    # two sequences of 1,000 rows as views of one fused (B, S, Hq + 2 Hkv,
    # D) float32 projection at qwen3_1_7b's heads, windows of one key,
    # inside a tile, one tile, four and past S: the float32 tensor-core
    # body reads the strides, each call counted as windowed
    qkv = _randn((2, 1000, 16 + 2 * 8, 128), torch.float32, cuda, window)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
    want, want_lse = flash_ref.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), window=window,
        return_lse=True)
    before = _window_counts()
    got, lse = flash_kernel.flash_attention(q, k, v, window=window,
                                            return_lse=True)
    torch.cuda.synchronize()
    assert _window_counts() == (before[0] + 1, before[1], before[2] + 1,
                                before[3], before[4] + 1)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)


def test_train_grads_through_the_tf32_body_match_plain(cuda, monkeypatch):
    # a 2-layer float32 qwen3 at head dim 64: _FlashTrain's forward (with
    # lse) on the float32 tensor-core body, the loss and every gradient
    # against the plain flash's at 1e-4 x max|.|
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as attention_mod
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              attn_flash_block=64, d_model=256, num_heads=4,
                              num_kv_heads=2, head_dim=64)
    params = init_params(cfg, 3, device="cpu").to(cuda)
    g = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    fa = flash_kernel.flash_attention
    before = (fa.tf32_launches, fa.lse_launches)
    loss, grads = _train_grads(cfg, params, batch, cuda)
    assert (fa.tf32_launches - before[0], fa.lse_launches - before[1]) == \
        (4, 4)
    monkeypatch.setattr(attention_mod, "flash_attention",
                        flash_ref.flash_attention)
    want_loss, want = _train_grads(cfg, params, batch, cuda)
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    for name, w in want.items():
        err = float((grads[name] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("b,h,s,p,n,chunk,init", [
    (1, 3, 0, 64, 128, 128, True),        # no rows: the state passes through
    (1, 2, 129, 130, 7, 128, True),       # P in three tiles, odd N
    (2, 4, 1024, 64, 128, 128, True),     # B 2 at mamba2's widths
    (1, 3, 17, 64, 128, 16, False),       # ragged at chunk 16
    (2, 2, 16, 64, 24, 16, True),         # one full chunk of 16
    (1, 5, 127, 40, 128, 128, False),     # S one short of a chunk
    (1, 6, 300, 64, 16, 64, True)])       # jamba's state and chunk
def test_ssd_f32_chunked_body_edges(cuda, b, h, s, p, n, chunk, init):
    # float32 x, B and C on the chunked body (every operand split in two
    # bfloat16 terms), at the float32 bound 1e-4 x max(1, max|plain|)
    x, dt, a, bm, cm, st0 = _ssd_inputs(b, h, s, p, n, torch.float32, cuda,
                                        s + n, init)
    before = ssd_kernel.ssd_scan.launches
    y, state = ssd_kernel.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                   init_state=st0)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_scan.launches == before + 1
    assert y.shape == x.shape and y.dtype == torch.float32
    if s == 0:
        assert torch.equal(state, st0)
        return
    want_y, want_state = ssd_ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                          init_state=st0)
    _ssd_close(y, want_y, SSD_TOL[torch.float32], "y")
    _ssd_close(state, want_state, SSD_TOL[torch.float32], "final state")


@pytest.mark.parametrize("offset", [0, 1])
def test_ssd_f32_model_layout_at_prefill_width(cuda, offset):
    # ops.ssd_chunked on float32 slices of one conv output at mamba2_1_3b's
    # widths (64 heads x 64, N 128, chunk 128), S 512: 16-byte rows take
    # the float4 staging; one element in, the element-wise staging
    s, h, p, n = 512, 64, 64, 128
    g = torch.Generator().manual_seed(24)
    xbc = torch.randn(1, s, offset + h * p + 2 * n, generator=g)
    xbc[..., offset + h * p:] /= 2
    xbc = xbc.to(cuda)[..., offset:]
    x = xbc[..., :h * p].reshape(1, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.randn(1, s, h, generator=g)).to(cuda) / 2
    a = -torch.exp(torch.randn(h, generator=g) * 0.3).to(cuda)
    y, state = ssd_ops.ssd_chunked(x, dt, a, bm, cm, chunk=128)
    want_y, want_state = ssd_ref.ssd_scan(
        x.transpose(1, 2), dt.transpose(1, 2), a, bm, cm, chunk=128)
    _ssd_close(y.transpose(1, 2), want_y, SSD_TOL[torch.float32], "y")
    _ssd_close(state, want_state, SSD_TOL[torch.float32], "final state")
