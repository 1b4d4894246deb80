"""The tree pass for the bucketed fill kernel, emulated in plain torch on
the CPU.

The tree pass evaluates m bisection levels a pass: the usage at all
2^m - 1 midpoints of the next m levels of the bisection tree, each
computed from its interval's ends by 0.5*(a + b), and then walks the tree
with the crossing decisions (the last pass takes the levels that remain).
``csrc/psdsf_fill_bucketed.cu`` takes one level a pass, since on an H100
the extra points cost more than the passes they save (PERF.md); these
tests keep the proof that the tree pass is exact. ``tree_event`` does it
with the plain version's own usage contraction, so it must equal
``ref.fill_event_levels_bucketed`` (the sequential bisection) exactly, in
float64 and float32, at every m, for any step count, a collapsed bracket,
a server with no live slot and R = 1..8; and it is held to the Pallas
kernel in interpret mode as the plain version is
(tests/test_torch_bucketed.py). The CUDA kernel itself is held against the
plain version on a card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.psdsf_fill_bucketed import kernel as jax_kernel
from repro_torch.kernels.psdsf_fill_bucketed import kernel as port_kernel
from repro_torch.kernels.psdsf_fill_bucketed import ref as port_ref

STEPS = [0, 1, 2, 3, 26, 47, 48]


def tree_event(floors, rate, dem_b, caps, frozen, saturated, level, *,
               steps, m):
    """``ref.fill_event_levels_bucketed`` with the bisection taken m levels
    a pass, as the CUDA kernel takes it."""
    slope = port_ref._contract(rate, dem_b)
    zero = torch.zeros((), dtype=floors.dtype)
    fmax = torch.where(rate > 0, floors, zero).amax(dim=1) \
        if floors.shape[1] else torch.zeros_like(level)
    hi0 = torch.maximum(fmax.clamp(min=0.0), level)
    canb = ~saturated & (slope > port_ref.TOL)
    head = (caps - frozen
            - port_ref._usage(rate, floors, dem_b, hi0)).clamp(min=0.0)
    step_up = torch.where(canb, head / slope.clamp(min=port_ref.TOL),
                          torch.full_like(head, port_ref.BIG)).amin(dim=1)
    lo = level
    hi = torch.where(canb.any(dim=1), hi0 + step_up, lo)
    servers = torch.arange(floors.shape[0])
    rem = steps
    while rem > 0:
        levels = min(m, rem)
        # the tree's points in heap order: node n spans (a[n], b[n]), its
        # children are 2n+1 (the lower half) and 2n+2
        a, b, pts = [lo], [hi], []
        for n in range(2 ** levels - 1):
            pts.append(0.5 * (a[n] + b[n]))
            a += [a[n], pts[n]]
            b += [pts[n], b[n]]
        crossed = torch.stack([
            (canb & (frozen + port_ref._usage(rate, floors, dem_b, p)
                     >= caps)).any(dim=1) for p in pts])
        pts = torch.stack(pts)
        node = torch.zeros_like(servers)
        for _ in range(levels):
            mid = 0.5 * (lo + hi)
            assert torch.equal(mid, pts[node, servers])
            c = crossed[node, servers]
            lo, hi = torch.where(c, lo, mid), torch.where(c, mid, hi)
            node = 2 * node + torch.where(c, 1, 2)
        rem -= levels
    lvl = torch.maximum(hi, level)
    u = frozen + port_ref._usage(rate, floors, dem_b, lvl)
    lsl = port_ref._contract(rate * (floors <= lvl[:, None]), dem_b)
    return lvl, u, lsl, slope


def _inputs(r, k=12, bmax=37, seed=5):
    """One mid-loop bucketed event (numpy): ragged buckets, server 1 with
    an empty bucket, server 2 with slots but none live, server 0 with every
    resource saturated (a collapsed bracket), padded and frozen slots inert,
    nonzero frozen usage and levels."""
    rng = np.random.default_rng(seed + r)
    counts = rng.integers(1, bmax + 1, k)
    counts[1] = 0
    mask = np.arange(bmax)[None, :] < counts[:, None]
    live = mask & (rng.random((k, bmax)) > 0.2)
    live[2] = False
    rate = np.where(live, rng.uniform(0.5, 8.0, (k, bmax)), 0.0)
    floors = np.where(live, rng.uniform(0.0, 2.0, (k, bmax)), 0.0)
    dem = rng.uniform(0.05, 2.0, (k, bmax, r))
    caps = rng.uniform(5.0, 50.0, (k, r))
    frozen = rng.uniform(0.0, 0.3, (k, r)) * caps
    sat = rng.random((k, r)) < 0.15
    sat[0] = True
    level = rng.uniform(0.0, 0.5, k)
    return floors, rate, dem, caps, frozen, sat, level


def _torch(arrays, dtype):
    floors, rate, dem, caps, frozen, sat, level = arrays
    return [*(torch.as_tensor(a, dtype=dtype)
              for a in (floors, rate, dem, caps, frozen)),
            torch.as_tensor(sat), torch.as_tensor(level, dtype=dtype)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_tree_pass_equals_sequential_bisection(m, steps, r, dtype):
    args = _torch(_inputs(r), dtype)
    got = tree_event(*args, steps=steps, m=m)
    want = port_ref.fill_event_levels_bucketed(*args, steps=steps)
    for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                            got, want):
        assert torch.equal(g_, w_), name
    # the collapsed bracket and the server with no live slot are no-ops
    assert float(got[0][0]) == float(args[6][0])
    assert float(got[0][2]) == float(args[6][2])


@pytest.mark.parametrize("r", [1, 4, 8])
def test_tree_pass_moves_levels(r):
    # the event is not vacuous: most servers' levels rise
    args = _torch(_inputs(r), torch.float64)
    lvl = tree_event(*args, steps=48, m=3)[0]
    assert int((lvl > args[6]).sum()) >= 6


@pytest.fixture()
def x64():
    with jax.enable_x64(True):
        yield


def _pallas(arrays, steps, dtype):
    floors, rate, dem, caps, frozen, sat, level = arrays
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    return jax_kernel.fill_event_levels_bucketed(
        *(jnp.asarray(a, jd) for a in (floors, rate, dem, caps, frozen)),
        jnp.asarray(sat, jd), jnp.asarray(level, jd), steps=steps,
        interpret=True)


@pytest.mark.parametrize("steps", [48, 5])
@pytest.mark.parametrize("m", [2, 3])
def test_tree_pass_matches_pallas_f64(x64, m, steps):
    arrays = _inputs(4)
    got = tree_event(*_torch(arrays, torch.float64), steps=steps, m=m)
    want = _pallas(arrays, steps, torch.float64)
    for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                            got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-9, err_msg=name)


@pytest.mark.parametrize("m", [1, 3])
def test_tree_pass_matches_pallas_f32(m):
    # float32 sums in another order: the reference's 5e-6 x scale bound
    arrays = _inputs(4)
    got = tree_event(*_torch(arrays, torch.float32), steps=26, m=m)
    want = _pallas(arrays, 26, torch.float32)
    for name, g_, w_ in zip(("level", "usage", "local_slope", "slope"),
                            got, want):
        w_ = np.asarray(w_, np.float64)
        scale = max(1.0, float(np.abs(w_).max()))
        assert float(np.abs(g_.double().numpy() - w_).max()) \
            <= 5e-6 * scale, name


@pytest.mark.parametrize("bmax,r,dtype,want", [
    (692, 4, torch.float64, ("registers", 6)),
    (662, 4, torch.float32, ("registers", 12)),
    (1, 8, torch.float64, ("registers", 1)),
    (1024, 4, torch.float64, ("registers", 8)),
    (1025, 4, torch.float64, ("shared", 0)),
    (1024, 4, torch.float32, ("registers", 16)),
    (257, 8, torch.float64, ("registers", 4)),
    (513, 8, torch.float64, ("shared", 0)),
    (6000, 8, torch.float64, ("streamed", 0)),
    (4000, 8, torch.float32, ("shared", 0))])
def test_plan_picks_the_path(bmax, r, dtype, want):
    how = port_kernel.plan(bmax, r, dtype, steps=48)
    assert (how["path"], how["slots"]) == want
    threads = port_kernel.THREADS[dtype]
    assert how["threads"] == threads
    if how["path"] == "registers":
        # the fewest instantiated slots that cover the bucket
        assert how["slots"] * threads >= bmax
        smaller = [s for s in port_kernel.REG_SLOTS if s < how["slots"]]
        assert not smaller or smaller[-1] * threads < bmax
    assert how["passes"] == 3 + 48


def test_plan_forced_paths(monkeypatch):
    monkeypatch.setattr(port_kernel, "REG_SLOTS", ())
    assert port_kernel.plan(692, 4, torch.float64, 48)["path"] == "shared"
    monkeypatch.setattr(port_kernel, "SMEM_STAGE_MAX", 0)
    assert port_kernel.plan(692, 4, torch.float64, 48)["path"] == "streamed"
    monkeypatch.undo()
    # the plan is cached by the thresholds too: restoring them restores it
    assert port_kernel.plan(692, 4, torch.float64, 48)["path"] == "registers"
    assert port_kernel.plan(662, 4, torch.float32, 26)["passes"] == 29
