"""The port's plain ``ssd_scan`` (``repro_torch/kernels/ssd_scan``) against
the JAX reference on the CPU: the Pallas ``ssd_scan`` in interpret mode,
its sequential oracle ``ssd_scan_ref`` and the model's ``_ssd_chunked``
(final state included, at ragged lengths too), on the same float32 inputs
made with numpy. Tolerances are the JAX tests' own
(tests/test_kernel_ssd_and_decode.py): 1e-4 against the kernel and the
recurrence, 2e-4 against ``_ssd_chunked``, as rtol and atol. The kernel
wrapper takes the plain version for CPU tensors (never building)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels.ssd_scan.kernel import ssd_scan as pallas_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.models.ssm import _ssd_chunked
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import kernel, ops, ref

TOL = 1e-4
MODEL_TOL = 2e-4


def _inputs(b, h, s, p, n, seed=0, layout="bhsp"):
    """x, dt (post-softplus, > 0), a (< 0), B, C as float32 numpy arrays in
    the kernel's (B, H, S, P) layout or the model's (B, S, H, P)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, s, p)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((b, h, s)), 0) * 0.5) \
        .astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    if layout == "bshp":
        x, dt = x.transpose(0, 2, 1, 3).copy(), dt.transpose(0, 2, 1).copy()
    return x, dt, a, bm, cm


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (1, 2, 128, 32, 16, 32),
    (2, 4, 256, 64, 32, 64),
    (1, 1, 64, 16, 8, 64),     # single chunk
])
def test_plain_matches_pallas_kernel_and_recurrence(b, h, s, p, n, chunk):
    arrays = _inputs(b, h, s, p, n)
    want = np.asarray(pallas_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                      interpret=True))
    y, _ = ref.ssd_scan(*_t(arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)
    seq = np.asarray(ssd_scan_ref(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(y.numpy(), seq, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,chunk", [(37, 16), (16, 16), (5, 32)])
def test_sequential_matches_reference_oracle(s, chunk):
    arrays = _inputs(2, 3, s, 8, 4, seed=1)
    want = np.asarray(ssd_scan_ref(*map(jnp.asarray, arrays)))
    y_seq, st_seq = ref.ssd_scan_sequential(*_t(arrays))
    np.testing.assert_allclose(y_seq.numpy(), want, rtol=TOL, atol=TOL)
    # the chunked version at a ragged length, state included
    y, st = ref.ssd_scan(*_t(arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st.numpy(), st_seq.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("s", [64, 100, 7])
@pytest.mark.parametrize("init", [False, True])
def test_ops_matches_model_ssd_chunked(s, init):
    # the smoke config's chunk 16; at S 100 the reference halves its chunk
    # to 4 (100 % 16 != 0) and the port pads the last chunk instead
    cfg = get_smoke_config("mamba2_1_3b")
    b, h, p, n = 2, 3, 16, 16
    x, dt, a, bm, cm = _inputs(b, h, s, p, n, seed=s, layout="bshp")
    s0 = (np.random.default_rng(9).standard_normal((b, h, p, n))
          .astype(np.float32) if init else None)
    y_ref, st_ref = _ssd_chunked(
        cfg, *map(jnp.asarray, (x, dt, a, bm, cm)),
        init_state=None if s0 is None else jnp.asarray(s0))
    y, st = ops.ssd_chunked(*_t((x, dt, a, bm, cm)), chunk=cfg.ssm_chunk,
                            init_state=None if s0 is None
                            else torch.from_numpy(s0))
    assert y.shape == (b, s, h, p) and y.is_contiguous()
    assert st.shape == (b, h, p, n) and st.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref),
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def test_padded_tail_leaves_state_unchanged():
    # one chunk of 16 holding 5 rows equals the same 5 rows at chunk 8 and
    # the recurrence: the zero-dt padding adds nothing and decays nothing
    arrays = _t(_inputs(1, 2, 5, 8, 4, seed=3))
    y16, st16 = ref.ssd_scan(*arrays, chunk=16)
    y8, st8 = ref.ssd_scan(*arrays, chunk=8)
    y1, st1 = ref.ssd_scan_sequential(*arrays)
    for y, st in ((y8, st8), (y1, st1)):
        torch.testing.assert_close(y16, y, rtol=TOL, atol=TOL)
        torch.testing.assert_close(st16, st, rtol=TOL, atol=TOL)


def test_bf16_input_keeps_dtype_and_float32_state():
    x, dt, a, bm, cm = _t(_inputs(1, 2, 20, 8, 4, seed=4))
    y, st = ref.ssd_scan(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(),
                         chunk=16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    y32, st32 = ref.ssd_scan(x.bfloat16().float(), dt, a,
                             bm.bfloat16().float(), cm.bfloat16().float(),
                             chunk=16)
    torch.testing.assert_close(y, y32.bfloat16())
    torch.testing.assert_close(st, st32)


def test_wrapper_takes_plain_version_for_cpu_tensors(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    x, dt, a, bm, cm = _t(_inputs(1, 2, 40, 8, 4, seed=5))
    before = kernel.ssd_scan.launches
    y, st = kernel.ssd_scan(x, dt, a, bm, cm, chunk=16)
    want_y, want_st = ref.ssd_scan(x, dt, a, bm, cm, chunk=16)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    out = torch.empty(1, 40, 2, 8).transpose(1, 2)
    y2, _ = kernel.ssd_scan(x, dt, a, bm, cm, chunk=16, out=out)
    assert y2 is out and torch.equal(out, want_y)
    assert kernel.ssd_scan.launches == before
    meta = torch.empty((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel.ssd_scan(meta, meta[..., 0], meta[0, :, 0, 0], meta[:, 0],
                        meta[:, 0])
