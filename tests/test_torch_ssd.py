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
import torch.nn.functional as F

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


# -- the chunk decomposition of the Hopper bfloat16 body, in plain torch -----

def _split(v):
    """A float32 tensor as two bfloat16 terms, hi + lo."""
    hi = v.bfloat16()
    return hi, (v - hi.float()).bfloat16()


def _ssd_four_steps(x, dt, a, b_mat, c_mat, chunk, init_state=None):
    """What the bfloat16 body of ``csrc/ssd_scan.cu`` computes, step for
    step, in the kernel's (B, H, S, P) layout, on bfloat16 x, B and C:
    (1) the scores C_c B_c^T once per chunk for all heads; (2) per (chunk,
    head) the delta sum_j (w_j x_j)^T B_j, w_j = exp(seg_last - seg_j) dt_j;
    (3) the state pass over the chunks, keeping each chunk's entry state;
    (4) y = exp(seg_i) C_i . entry^T + (G o decay o dt) x. Products take
    bfloat16 operands with float32 sums; a float32 operand (w x, the entry
    state, the decayed scores) is split into hi + lo bfloat16 terms, both
    multiplied in. Rows past S have dt = 0. Returns (y float32, final
    state)."""
    b, h, s, p = x.shape
    n = b_mat.shape[-1]
    q, nc = chunk, -(-s // chunk)
    pad = nc * q - s
    xc = F.pad(x.float(), (0, 0, 0, pad)).reshape(b, h, nc, q, p)
    dtc = F.pad(dt.float(), (0, pad)).reshape(b, h, nc, q)
    bc = F.pad(b_mat.float(), (0, 0, 0, pad)).reshape(b, nc, q, n)
    cc = F.pad(c_mat.float(), (0, 0, 0, pad)).reshape(b, nc, q, n)
    seg = torch.cumsum(dtc * a.float()[None, :, None, None], dim=-1)
    last = seg[..., -1:]
    g = torch.einsum("bcin,bcjn->bcij", cc, bc)                       # (1)
    hi, lo = _split(torch.exp(last - seg)[..., None] * dtc[..., None] * xc)
    delta = sum(torch.einsum("bhcjp,bcjn->bhcpn", t.float(), bc)      # (2)
                for t in (hi, lo))
    state = (torch.zeros(b, h, p, n) if init_state is None
             else init_state.float())
    entry = []
    for c in range(nc):                                               # (3)
        entry.append(state)
        state = state * torch.exp(last[:, :, c])[..., None] + delta[:, :, c]
    eh, el = _split(torch.stack(entry, dim=2))
    y = sum(torch.einsum("bcin,bhcpn->bhcip", cc, t.float())          # (4)
            for t in (eh, el)) * torch.exp(seg)[..., None]
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    w = torch.where(causal, g[:, None] * torch.exp(
        seg[..., :, None] - seg[..., None, :]) * dtc[..., None, :], 0.0)
    wh, wl = _split(w)
    y = y + sum(torch.einsum("bhcij,bhcjp->bhcip", t.float(), xc)
                for t in (wh, wl))
    return y.reshape(b, h, nc * q, p)[:, :, :s], state


def _bf16_inputs(b, h, s, p, n, seed, layout="bhsp"):
    """_inputs with x, B and C rounded to bfloat16 values (float32)."""
    x, dt, a, bm, cm = _inputs(b, h, s, p, n, seed=seed, layout=layout)
    rnd = [torch.from_numpy(t).bfloat16().float().numpy()
           for t in (x, bm, cm)]
    return rnd[0], dt, a, rnd[1], rnd[2]


def test_split_holds_float32_operands():
    # one bfloat16 rounding costs up to 2^-9 relative; hi + lo keeps 2^-17
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(10000)
                         .astype(np.float32)) * 37.0
    hi, lo = _split(v)
    one = ((hi.float() - v).abs() / v.abs()).max()
    two = ((hi.float() + lo.float() - v).abs() / v.abs()).max()
    assert one > 2.0 ** -10 and two <= 2.0 ** -17


@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (1, 2, 128, 32, 16, 32),
    (2, 4, 256, 64, 32, 64),
    (1, 1, 64, 16, 8, 64),     # single chunk
    (1, 3, 256, 64, 128, 128),  # mamba2_1_3b's head width, state, chunk
])
def test_four_step_plan_matches_pallas_kernel_and_recurrence(b, h, s, p, n,
                                                             chunk):
    arrays = _bf16_inputs(b, h, s, p, n, seed=s + n)
    want = np.asarray(pallas_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                      interpret=True))
    y, st = _ssd_four_steps(*_t(arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)
    seq = np.asarray(ssd_scan_ref(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(y.numpy(), seq, rtol=TOL, atol=TOL)
    _, st_seq = ref.ssd_scan_sequential(*_t(arrays))
    np.testing.assert_allclose(st.numpy(), st_seq.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("s", [64, 100, 7])
@pytest.mark.parametrize("init", [False, True])
def test_four_step_plan_matches_model_ssd_chunked(s, init):
    # the smoke config's chunk 16: a ragged tail at S 100 and S 7 < chunk,
    # with and without an initial state, final state included
    cfg = get_smoke_config("mamba2_1_3b")
    b, h, p, n = 2, 3, 16, 16
    x, dt, a, bm, cm = _bf16_inputs(b, h, s, p, n, seed=s, layout="bshp")
    s0 = (np.random.default_rng(9).standard_normal((b, h, p, n))
          .astype(np.float32) if init else None)
    y_ref, st_ref = _ssd_chunked(
        cfg, *map(jnp.asarray, (x, dt, a, bm, cm)),
        init_state=None if s0 is None else jnp.asarray(s0))
    y, st = _ssd_four_steps(
        *_t((x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), a, bm, cm)),
        chunk=cfg.ssm_chunk,
        init_state=None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(y.transpose(1, 2).numpy(), np.asarray(y_ref),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref),
                               rtol=MODEL_TOL, atol=MODEL_TOL)


@pytest.mark.parametrize("s,chunk", [(37, 16), (5, 128), (300, 128)])
def test_four_step_plan_ragged_matches_plain_and_sequential(s, chunk):
    # a ragged last chunk and an initial state: y and the final state
    # against the plain chunked version and the recurrence
    x, dt, a, bm, cm = _t(_bf16_inputs(2, 3, s, 24, 12, seed=s))
    s0 = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (2, 3, 24, 12)).astype(np.float32))
    y, st = _ssd_four_steps(x, dt, a, bm, cm, chunk=chunk, init_state=s0)
    for want_y, want_st in (
            ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk, init_state=s0),
            ref.ssd_scan_sequential(x, dt, a, bm, cm, init_state=s0)):
        torch.testing.assert_close(y, want_y, rtol=TOL, atol=TOL)
        torch.testing.assert_close(st, want_st, rtol=TOL, atol=TOL)


def test_scratch_size_counts_the_four_buffers():
    # scores (B, nc, Q, Q), deltas (B, nc, H, P, N), entry states as hi and
    # lo bfloat16 (the same bytes) and decays (B, H, nc), in float32 values;
    # 16.8 MB of deltas at mamba2's prefill
    assert kernel.scratch_size(1, 64, 1024, 64, 128, 128) == \
        8 * 128 * 128 + 2 * 8 * 64 * 64 * 128 + 64 * 8
    assert kernel.scratch_size(2, 3, 100, 16, 16, 16) == \
        2 * 7 * (16 * 16 + 2 * 3 * 16 * 16 + 3)
