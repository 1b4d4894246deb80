"""Parity of the port's Eq. 16 reduction (``psdsf_vds`` plain version and
``core.dynamic.min_vds_guarded`` on the CPU) with the JAX reference: the
Pallas kernel in interpret mode and ``repro.core.dynamic.min_vds_guarded``.
Argmins must be equal, minima within rtol 1e-6. The CUDA kernel is held
against this plain version by tests/test_torch_cuda.py on a card."""
import numpy as np
import pytest
import torch

from repro.core import dynamic as jax_dynamic
from repro.kernels.psdsf_vds.kernel import vds_argmin as pallas_vds_argmin
from repro.kernels.psdsf_vds.ops import min_vds_padded
from repro_torch.core.dynamic import min_vds_guarded
from repro_torch.kernels.psdsf_vds import ref as port_ref
from repro_torch.kernels.psdsf_vds.ops import min_vds


def _inputs(n=96, k=24, seed=5):
    """x/phi and gamma with an all-ineligible column and exact ties."""
    rng = np.random.default_rng(seed)
    x_over_phi = rng.uniform(0.0, 10.0, n).astype(np.float32)
    gamma = (rng.uniform(0.0, 2.0, (n, k))
             * (rng.random((n, k)) > 0.4)).astype(np.float32)
    gamma[:, min(3, k - 1)] = 0.0          # no eligible user: BIG, row 0
    if n >= 96 and k >= 8:
        # ties: rows 10/40/70 win column 5 with equal values
        gamma[:, 5] = np.where(gamma[:, 5] > 0, 0.01, 0.0)
        for row in (10, 40, 70):
            x_over_phi[row] = 0.5
            gamma[row, 5] = 4.0
        # zero numerators tie at 0 in column 6 (and stay out of column 5)
        x_over_phi[[20, 21]] = 0.0
        gamma[[20, 21], 5] = 0.0
        gamma[[20, 21], 6] = 1.0
    return x_over_phi, gamma


def _check(got, want_mn, want_arg):
    mn, arg = got
    assert mn.dtype == torch.float32 and arg.dtype == torch.int32
    np.testing.assert_array_equal(arg.cpu().numpy(), np.asarray(want_arg))
    np.testing.assert_allclose(mn.cpu().numpy(), np.asarray(want_mn),
                               rtol=1e-6)


def test_vds_argmin_matches_pallas():
    x_over_phi, gamma = _inputs()
    want = pallas_vds_argmin(x_over_phi, gamma, interpret=True)
    got = port_ref.vds_argmin(torch.as_tensor(x_over_phi),
                              torch.as_tensor(gamma))
    _check(got, *want)
    assert int(got[1][5]) == 10 and int(got[1][6]) == 20
    assert int(got[1][3]) == 0 and float(got[0][3]) == pytest.approx(3e38)


@pytest.mark.parametrize("n,k", [(300, 130), (7, 3), (1, 1)])
def test_min_vds_ragged_matches_padded_reference(n, k):
    x_over_phi, gamma = _inputs(n, k, seed=n)
    want = min_vds_padded(x_over_phi, gamma, interpret=True)
    _check(min_vds(torch.as_tensor(x_over_phi), torch.as_tensor(gamma)),
           *want)


def _telemetry_case(seed=3, n=64, k=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 3.0, (n, k)) * (rng.random((n, k)) > 0.5)
    weights = rng.uniform(0.5, 2.0, n)
    gamma = rng.uniform(0.5, 8.0, (n, k)) * (rng.random((n, k)) > 0.3)
    active = rng.random(n) > 0.25
    weights[[1, 2]] = 0.0                 # zero-weight users mask out
    active[5] = True
    gamma[:, 2] = 0.0
    active[gamma[:, 4] > 0] = False       # every user of server 4 inactive
    return x, weights, gamma, active


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_min_vds_guarded_matches_reference(seed):
    x, weights, gamma, active = _telemetry_case(seed)
    want = jax_dynamic.min_vds_guarded(x, weights, gamma, active,
                                       interpret=True)
    got = min_vds_guarded(x, weights, gamma, active, device="cpu")
    _check(got, *want)
    assert np.isfinite(got[0].numpy()).all()


def test_min_vds_guarded_all_inactive():
    x, weights, gamma, _ = _telemetry_case()
    active = np.zeros(len(weights), dtype=bool)
    mn, arg = min_vds_guarded(x, weights, gamma, active, device="cpu")
    assert (mn.numpy() == np.float32(3e38)).all()
    assert (arg.numpy() == 0).all()


# -- the CUDA kernel's grid: user slabs merged by (value, row) ---------------

def slab_merge(x_over_phi, gamma, rows, reverse=False):
    """``ref.vds_argmin`` taken as the CUDA kernel takes it: per slab of
    ``rows`` user rows the (min, lowest row), then the slabs merged by
    "smaller value, or equal value and lower row" (in either order)."""
    n = gamma.shape[0]
    parts = []
    for r0 in range(0, n, rows):
        mn, arg = port_ref.vds_argmin(x_over_phi[r0:r0 + rows],
                                      gamma[r0:r0 + rows])
        parts.append((mn, arg + r0))
    if reverse:
        parts.reverse()
    m, a = parts[0]
    for pm, pa in parts[1:]:
        better = (pm < m) | ((pm == m) & (pa < a))
        m, a = torch.where(better, pm, m), torch.where(better, pa, a)
    return m, a


def _slab_inputs():
    """``_inputs`` with ties that straddle slab boundaries: column 7 is
    won by rows 31, 32 and 63 (one value), column 8 by rows 0 and 95."""
    x_over_phi, gamma = _inputs()
    for col, rows in ((7, (31, 32, 63)), (8, (0, 95))):
        gamma[:, col] = np.where(gamma[:, col] > 0, 0.01, 0.0)
        gamma[[20, 21], col] = 0.0        # their zero numerators stay out
        for row in rows:
            x_over_phi[row] = 0.5
            gamma[row, col] = 4.0
    gamma[:, 9] = np.where(gamma[:, 9] > 0, 1.0, 0.0)  # one value throughout
    return x_over_phi, gamma


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows", [1, 7, 32, 33, 64, 95, 96, 500])
def test_slab_merge_equals_plain(rows, reverse):
    x_over_phi, gamma = _slab_inputs()
    xo, g = torch.as_tensor(x_over_phi), torch.as_tensor(gamma)
    mn, arg = slab_merge(xo, g, rows, reverse)
    pmn, parg = port_ref.vds_argmin(xo, g)
    assert torch.equal(mn, pmn) and torch.equal(arg, parg)
    assert int(arg[7]) == 31 and int(arg[8]) == 0
    assert int(arg[3]) == 0 and float(mn[3]) == pytest.approx(3e38)


@pytest.mark.parametrize("rows", [5, 32, 96])
def test_slab_merge_matches_pallas(rows):
    x_over_phi, gamma = _slab_inputs()
    want = pallas_vds_argmin(x_over_phi, gamma, interpret=True)
    got = slab_merge(torch.as_tensor(x_over_phi), torch.as_tensor(gamma),
                     rows)
    _check(got, *want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("n,k,sms,want", [
    (20000, 256, 132, dict(tiles=2, slabs=264, rows=76)),
    (20000, 1024, 132, dict(tiles=8, slabs=66, rows=304)),
    (96, 24, 132, dict(tiles=1, slabs=2, rows=48)),
    (1, 1, 132, dict(tiles=1, slabs=1, rows=1)),
    (63, 130, 132, dict(tiles=2, slabs=1, rows=63))])
def test_vds_grid(n, k, sms, want):
    from repro_torch.kernels.psdsf_vds.kernel import grid
    got = grid(n, k, sms)
    assert got == want
    # every slab holds a row; the slabs cover the users
    assert (got["slabs"] - 1) * got["rows"] < n <= got["slabs"] * got["rows"]
