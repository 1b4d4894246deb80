"""The port's Hopper kernels against their plain PyTorch versions on a
CUDA card. Every test here is marked ``gpu`` and skips without a card; on
one, run ``python -m pytest -q -m gpu tests/test_torch_cuda.py``. The file
imports neither jax nor ``repro`` (the card's machine has no jax): the plain
versions are held against the JAX reference by the CPU tests in
tests/test_torch_{fill,vds,solve}.py."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.gamma import gamma_matrix
from repro_torch.core.instances import dense_random_instance, fig2_instance
from repro_torch.kernels.psdsf_fill import kernel as fill_kernel
from repro_torch.kernels.psdsf_fill import ref as fill_ref
from repro_torch.kernels.psdsf_fill.ops import fill_cluster
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


def test_engine_solve_on_card_matches_cpu(cuda):
    prob = fig2_instance()
    kw = dict(fill="bisect", round="jacobi", tol=0.0, max_rounds=40)
    a_gpu, i_gpu = engine.solve(prob, device="cuda", **kw)
    a_cpu, i_cpu = engine.solve(prob, device="cpu", **kw)
    assert i_gpu.rounds == i_cpu.rounds
    np.testing.assert_allclose(a_gpu.x, a_cpu.x, rtol=0, atol=1e-9)
