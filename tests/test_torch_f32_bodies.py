"""The float32 bodies of the attention and SSD kernels on the tensor cores,
emulated step for step in plain torch on the CPU.

- Flash attention in split TF32 (``flash_tf32_kernel`` in
  ``csrc/flash_attention.cu``): each float32 operand as hi = a truncated to
  TF32 (its 13 low mantissa bits cleared, on the bits) and lo = a - hi,
  which the tensor cores read truncated as well; each product as lo·hi +
  hi·lo + hi·hi, each k8 step's three through ``mma.sync`` as modelled in
  ``_mma`` (float32 sums rounded toward zero), the scores' steps in zeroed
  fragments added in float32, O += P V chained; the kernel's blocks
  of 64 query rows, warps of 16, kv tiles of ``TF32_KV_ROWS`` rows, its
  skips and masks. Held against the port's plain version, the JAX oracle,
  the reference model's ``_attend`` and the Pallas kernel in interpret
  mode at the attention tests' float32 bounds: 2e-5 (rtol and atol) on
  the output, 1e-5 on the log-sum-exp; 3e-5 against ``_attend`` (that
  comparison's bound in tests/test_torch_attention.py). One TF32 product
  instead of three misses 2e-5: the reason for the split.
- ``ssd_scan``'s float32 entry on the chunked body: the four steps of
  tests/test_torch_ssd.py's bfloat16 plan with every float32 operand (x, B
  and C too) split into two bfloat16 terms and each product of two split
  operands taken as hi·hi + hi·lo + lo·hi. Held against the Pallas kernel
  in interpret mode, ``ssd_scan_ref``, the port's plain version and the
  model's ``_ssd_chunked`` at the SSD tests' bounds: 1e-4 (2e-4 against
  ``_ssd_chunked``). One bfloat16 rounding of the inputs misses 1e-4.

Inputs come from numpy seeds."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke_config
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.ssd_scan.kernel import ssd_scan as pallas_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.models.attention import _attend as jax_attend
from repro.models.ssm import _ssd_chunked
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ref as ssd_ref

TOL = 2e-5
LSE_TOL = 1e-5
ATTEND_TOL = 3e-5
SSD_TOL = 1e-4
SSD_MODEL_TOL = 2e-4
LOG2E = math.log2(math.e)


def _f32(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# -- TF32 on the bits ---------------------------------------------------------

def _tf32(a):
    """A float32 tensor as the tensor cores read a TF32 operand, on the
    bits: sign, exponent and the top 10 mantissa bits, the 13 low bits
    cleared (truncation toward zero)."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split_tf32(a):
    """The kernel's split: hi = a truncated to TF32, lo = a - hi (exact in
    float32), both as the tensor cores read them."""
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _rz(x64):
    """float64 values to float32, rounded toward zero."""
    x = x64.float()
    over = x.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x, torch.zeros_like(x)), x)


def _mma(c, a, b):
    """c + a @ b over K = 8 as one ``mma.sync.m16n8k8`` TF32 takes it, as
    modelled here: the eight products exact, they and c aligned to the
    largest one's exponent and truncated to 24 bits there, summed, the sum
    rounded toward zero to float32 (the tensor cores round their float32
    sums toward zero)."""
    prods = a.double().unsqueeze(-1) * b.double().unsqueeze(-3)
    terms = torch.cat([c.double().unsqueeze(-2), prods], -2)
    e = torch.frexp(terms.abs().amax(-2, keepdim=True))[1]
    ulp = torch.ldexp(torch.ones_like(terms[..., :1, :]), e - 24)
    return _rz((torch.trunc(terms / ulp) * ulp).sum(-2))


def _mma3_steps(a, b, c=None):
    """a @ b (K a multiple of 8) over k8 steps, both operands split into
    TF32 terms, each step's products lo·hi, hi·lo, hi·hi through ``_mma``
    (lo·lo left out). With c None, the kernel's scores: each step into a
    zeroed fragment, added to the sum in float32 (rounded to nearest).
    With c, the kernel's O += P V: every step chained through c."""
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    fresh = c is None
    if fresh:
        c = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        part = torch.zeros_like(c) if fresh else c
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = _mma(part, x[..., ks], y[..., ks, :])
        c = c + part if fresh else part
    return c


def _mma3_chained(a, b):
    """a @ b as ``_mma3_steps`` with every k8 step's products chained
    through one accumulator: the plan the kernel's scores do not take."""
    return _mma3_steps(a, b, torch.zeros(*a.shape[:-1], b.shape[-1]))


def _mm1(a, b):
    """One TF32 product: both operands read as TF32 once."""
    return _tf32(a) @ _tf32(b)


def test_tf32_truncation_on_the_bits():
    # 10 explicit mantissa bits: the low 13 cleared, toward zero; hi + lo
    # within 2^-20 of a (lo below 2^-10 |a|, itself truncated), hi alone
    # only within 2^-10
    a = torch.tensor([1.0, 1 + 2.0 ** -11, -(1 + 2.0 ** -10 + 2.0 ** -11),
                      1 + 2.0 ** -10, 3.0, -0.0, 2.0 ** -130])
    hi = _tf32(a)
    assert hi.tolist()[:5] == [1.0, 1.0, -(1 + 2.0 ** -10),
                               1 + 2.0 ** -10, 3.0]
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(10000)
                         .astype(np.float32)) * 37.0
    hi, lo = _split_tf32(v)
    one = ((hi - v).abs() / v.abs()).max()
    two = ((hi + lo - v).abs() / v.abs()).max()
    assert 2.0 ** -12 < one <= 2.0 ** -10 and two <= 2.0 ** -20


# -- flash attention in split TF32 --------------------------------------------

WARP_ROWS = 16


def _pv3(acc, p, v):
    """The kernel's O += P V, chained through the accumulator."""
    return _mma3_steps(p, v, acc)


def _flash_tf32(q, k, v, causal, window=0, mm=_mma3_steps, pv=_pv3,
                stats=None):
    """What ``flash_tf32_kernel`` computes, tile for tile, on float32 (B,
    S, H, D) inputs: blocks of ``TF32_BLOCK_ROWS`` query rows, 16 a warp,
    kv tiles of ``TF32_KV_ROWS[D]`` rows up to the block's causal limit
    and from the tile holding its first key q0 - W + 1 with a window
    (asserting that the tiles before it are wholly masked); a warp skips
    tiles wholly above its rows or wholly below its window and masks only
    tiles crossing its diagonal, the end of S or its window's lower edge
    (asserting both); rows past S are zeros. Scores through ``mm`` and O +=
    P V through ``pv`` (the split TF32 products, with the tensor cores'
    truncating sums), the scores times scale log2 e, the online
    softmax in log2 units, the output once at the end. Returns (out, lse),
    lse = m ln 2 + log l."""
    b, s, hq, d = q.shape
    bq, bk = flash_kernel.TF32_BLOCK_ROWS, flash_kernel.TF32_KV_ROWS[d]
    rep = hq // k.shape[2]
    scale_log2 = LOG2E / math.sqrt(d)
    qf = q.transpose(1, 2)                                      # (B, H, S, D)
    kf = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    stats = {} if stats is None else stats
    out = torch.zeros(b, hq, s, d)
    lse = torch.zeros(b, hq, s)

    def valid_at(rows, cols):
        ok = (cols[None, :] < s) & (~torch.tensor(causal)
                                    | (cols[None, :] <= rows[:, None]))
        if window:
            ok &= cols[None, :] > rows[:, None] - window
        return ok

    def count(key):
        stats[key] = stats.get(key, 0) + 1

    for q0 in range(0, s, bq):
        kv_end = min(s, q0 + bq) if causal else s
        ntiles = -(-kv_end // bk)
        t_first = max(0, q0 - window + 1) // bk if window else 0
        block = torch.arange(q0, min(q0 + bq, s))
        for tt in range(t_first):                       # never loaded
            cols = torch.arange(tt * bk, tt * bk + bk)
            assert not bool(valid_at(block, cols).any())
            count("not loaded")
        for first in range(q0, min(q0 + bq, s), WARP_ROWS):
            last = first + WARP_ROWS - 1
            rows = torch.arange(first, min(first + WARP_ROWS, s))
            m = torch.full((b, hq, len(rows), 1), -math.inf)
            l = torch.zeros(b, hq, len(rows), 1)
            acc = torch.zeros(b, hq, len(rows), d)
            for tt in range(t_first, ntiles):
                k0 = tt * bk
                cols = torch.arange(k0, k0 + bk)
                valid = valid_at(rows, cols)
                if (causal and k0 > last) or (
                        window and k0 + bk - 1 <= first - window):
                    assert not bool(valid.any()), (q0, first, k0)
                    count("skipped")
                    continue
                kt = torch.zeros(b, hq, bk, d)
                vt = torch.zeros(b, hq, bk, d)
                n = min(bk, s - k0)       # rows past S arrive as zeros
                kt[:, :, :n] = kf[:, :, k0:k0 + n]
                vt[:, :, :n] = vf[:, :, k0:k0 + n]
                sc = mm(qf[:, :, rows], kt.transpose(-1, -2)) * scale_log2
                lower = bool(window) and k0 <= last - window
                if (causal and k0 + bk - 1 > first) or k0 + bk > s or lower:
                    sc = sc.masked_fill(~valid, -math.inf)
                    count("masked")
                    if lower:
                        count("lower edge")
                else:
                    assert bool(valid.all()), (q0, first, k0)
                    count("unmasked")
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                base = torch.where(m_new == -math.inf, 0.0, m_new)
                corr = torch.exp2(m - base)
                p = torch.exp2(sc - base)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = pv(acc * corr, p, vt)
                m = m_new
            out[:, :, rows] = acc / l.clamp_min(1e-30)
            lse[:, :, rows] = (m * math.log(2)
                               + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out.transpose(1, 2), lse


def _qkv(b, s, hq, hkv, d, seed):
    arrays = _f32([(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)], seed)
    return arrays, [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s", [1, 65, 200])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_tf32_plan_matches_plain_and_jax(s, hq, hkv, d):
    # GQA 2:1 and MQA at head dims 64 and 128, S one row, one past a
    # block and ragged over four blocks; causal and not, each with its
    # lse; held against the plain version and the JAX oracle
    (q, k, v), (tq, tk, tv) = _qkv(2, s, hq, hkv, d, seed=s + d + hq)
    for causal in (True, False):
        stats = {}
        got, lse = _flash_tf32(tq, tk, tv, causal, stats=stats)
        plain, plain_lse = flash_ref.flash_attention(
            tq, tk, tv, causal=causal, return_lse=True)
        _close(got, plain)
        _close(lse, plain_lse, LSE_TOL)
        want = attention_ref(*(jnp.swapaxes(jnp.asarray(a), 1, 2)
                               for a in (q, k, v)), causal=causal)
        _close(got, jnp.swapaxes(want, 1, 2))
        # the causal diagonal and ragged S are the only masked tiles; with
        # kv tiles as long as the blocks no warp skips one
        assert (stats.get("masked", 0) > 0) == (
            causal or s % flash_kernel.TF32_KV_ROWS[d] != 0)
        assert "skipped" not in stats


def test_flash_tf32_plan_at_head_dim_256():
    # gemma_2b's 8:1 group at head dim 256 (32-row kv tiles, so the first
    # two warps of a causal block skip its last tile), ragged S, causal
    # and not, with the lse
    (q, k, v), (tq, tk, tv) = _qkv(1, 100, 8, 1, 256, seed=256)
    for causal in (True, False):
        stats = {}
        got, lse = _flash_tf32(tq, tk, tv, causal, stats=stats)
        assert (stats.get("skipped", 0) > 0) == causal
        plain, plain_lse = flash_ref.flash_attention(
            tq, tk, tv, causal=causal, return_lse=True)
        _close(got, plain)
        _close(lse, plain_lse, LSE_TOL)
        want = attention_ref(*(jnp.swapaxes(jnp.asarray(a), 1, 2)
                               for a in (q, k, v)), causal=causal)
        _close(got, jnp.swapaxes(want, 1, 2))


@pytest.mark.parametrize("window", [1, 40, 64, 200, 400])
def test_flash_tf32_plan_with_window(window):
    # S 300 (ragged), GQA 2:1 at head dim 64; windows of one key, inside
    # a tile, one tile, several and past S: the tiles before a block's
    # first key are not loaded, those crossing a warp's lower edge masked,
    # those wholly below it skipped; held against the plain version (with
    # its lse) and the reference model's _attend with that window
    s, hq, hkv, d = 300, 4, 2, 64
    (q, k, v), (tq, tk, tv) = _qkv(1, s, hq, hkv, d, seed=window)
    stats = {}
    got, lse = _flash_tf32(tq, tk, tv, True, window, stats=stats)
    plain, plain_lse = flash_ref.flash_attention(tq, tk, tv, window=window,
                                                 return_lse=True)
    _close(got, plain)
    _close(lse, plain_lse, LSE_TOL)
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              sliding_window=window)
    want = jax_attend(cfg, *(jnp.asarray(a) for a in (q, k, v)), q_offset=0)
    _close(got, want, ATTEND_TOL)
    assert (stats.get("lower edge", 0) > 0) == (window < s)
    bk = flash_kernel.TF32_KV_ROWS[d]
    last_block = (s - 1) // 64 * 64
    assert (stats.get("not loaded", 0) > 0) == (last_block - window + 1
                                                >= bk)


def test_flash_tf32_plan_matches_model_attend():
    # the model's causal attention at qwen3_1_7b's head dim, 45 rows
    cfg = get_smoke_config("qwen3_1_7b")
    (q, k, v), (tq, tk, tv) = _qkv(2, 45, 4, 2, 128, seed=7)
    got, _ = _flash_tf32(tq, tk, tv, True)
    want = jax_attend(cfg, *(jnp.asarray(a) for a in (q, k, v)), q_offset=0)
    _close(got, want, ATTEND_TOL)


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 128), (4, 4, 64)])
def test_flash_tf32_plan_matches_pallas_interpret(hq, hkv, d):
    # S 256, which the Pallas kernel's 128-row blocks divide
    (q, k, v), (tq, tk, tv) = _qkv(1, 256, hq, hkv, d, seed=hq + d)
    got, _ = _flash_tf32(tq, tk, tv, True)
    want = jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=True, block_q=128, block_k=128,
                               interpret=True)
    _close(got, want)


def test_one_tf32_product_misses_the_float32_bound():
    # qwen3_1_7b's 16/8 x 128 at S 256: one TF32 product an operand pair
    # (2^-10 an operand) puts the output past 2e-5 of the plain version
    # (3.8e-3 here); the three-product split stays under a fifth of it
    # (what is left is the float32 sums' order)
    _, (tq, tk, tv) = _qkv(1, 256, 16, 8, 128, seed=11)
    plain = flash_ref.flash_attention(tq, tk, tv)
    one, _ = _flash_tf32(tq, tk, tv, True, mm=_mm1,
                         pv=lambda acc, p, vt: acc + _mm1(p, vt))
    three, _ = _flash_tf32(tq, tk, tv, True)
    err_one = float((one - plain).abs().max())
    err_three = float((three - plain).abs().max())
    assert err_one > TOL and err_three < TOL / 5, (err_one, err_three)


def test_scores_chained_through_the_mma_drift_toward_zero():
    # the tensor cores round their float32 sums toward zero. Chaining a
    # score's D / 8 x 3 products through one accumulator (96 sums at head
    # dim 256) rounds the growing score each time, so the scores drift
    # toward zero and the lse with them: on the card that plan missed lse
    # 1e-5 (1.0e-5 at D 256). The kernel sums each k8 step's products in a
    # zeroed fragment and adds it in float32. Under this file's model of
    # the sums (``_mma``) the chained plan's lse error over seeds is 4e-6 to
    # 1.4e-5, so what is held here is its drift: twice the zeroed
    # fragments' toward zero, and three times their lse error, which stays
    # under a quarter of 1e-5
    h, s, d = 4, 128, 256
    q, k = (torch.from_numpy(a) for a in _f32([(h, s, d), (h, s, d)], 0))
    kt = k.transpose(-1, -2)
    exact = q.double() @ kt.double()
    causal = torch.ones(s, s, dtype=torch.bool).tril()

    def lse_err(scores):
        def lse(x):
            return torch.logsumexp((x.double() / math.sqrt(d))
                                   .masked_fill(~causal, -math.inf), -1)
        return float((lse(scores) - lse(exact)).abs().max())

    def drift(scores):
        return float(((scores.double() - exact) * exact.sign()).mean())

    fresh, chained = _mma3_steps(q, kt), _mma3_chained(q, kt)
    assert lse_err(fresh) < LSE_TOL / 4
    assert lse_err(chained) > 3 * lse_err(fresh)
    assert drift(chained) < 1.5 * drift(fresh) < 0


def test_tf32_body_choice():
    # float32 at head dims 64, 128 and 256 on rows cp.async copies 16
    # bytes at a time takes the float32 tensor-core body; bf16, other head
    # dims, rows off 16 bytes and strides off 4 elements do not; the plan
    # is 64 query rows a block and kv tiles of 64 rows (32 at 256)
    assert flash_kernel.TF32_HEAD_DIMS == (64, 128, 256)
    assert flash_kernel.TF32_BLOCK_ROWS == 64
    assert flash_kernel.TF32_KV_ROWS == {64: 64, 128: 64, 256: 32}
    for d in (64, 128, 256):
        q = torch.zeros(1, 8, 4, d)
        k = torch.zeros(1, 8, 2, d)
        assert flash_kernel.takes_tf32_body(q, k, k)
        assert not flash_kernel.takes_hopper_body(q, k, k)
        assert not flash_kernel.takes_tf32_body(q.bfloat16(), k.bfloat16(),
                                                k.bfloat16())
    for d in (32, 96, 136):
        q = torch.zeros(1, 8, 4, d)
        k = torch.zeros(1, 8, 2, d)
        assert not flash_kernel.takes_tf32_body(q, k, k)
    # a fused (B, S, Hq + 2 Hkv, D) projection's views: the model's layout
    qkv = torch.zeros(2, 8, 8, 128)
    assert flash_kernel.takes_tf32_body(qkv[:, :, :4], qkv[:, :, 4:6],
                                        qkv[:, :, 6:])
    # one element in: rows 4 bytes off 16; rows 66 floats apart
    wide = torch.zeros(1, 8, 4, 129)
    k = torch.zeros(1, 8, 2, 128)
    assert not flash_kernel.takes_tf32_body(wide[..., 1:], k, k)
    odd = torch.zeros(1, 8, 2, 66)
    assert not flash_kernel.takes_tf32_body(
        torch.zeros(1, 8, 4, 64), odd[..., :64], odd[..., :64])
    # the CPU wrapper runs the plain version and counts no launch
    before = (flash_kernel.flash_attention.launches,
              flash_kernel.flash_attention.tf32_launches)
    q = torch.randn(1, 8, 4, 64)
    k = torch.randn(1, 8, 2, 64)
    assert torch.equal(flash_kernel.flash_attention(q, k, k),
                       flash_ref.flash_attention(q, k, k))
    assert (flash_kernel.flash_attention.launches,
            flash_kernel.flash_attention.tf32_launches) == before


# -- ssd_scan's float32 entry on the chunked body ------------------------------

def _split_bf16(v):
    """A float32 tensor as two bfloat16 terms, hi + lo (float32 values)."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _prod(eq, a, b, split=True):
    """einsum(eq, a, b) the way the chunked body takes a product of two
    float32 operands: each split into hi + lo bfloat16 terms, hi·hi + hi·lo
    + lo·hi (each product exact in float32, float32 sums); ``split=False``
    rounds each operand to bfloat16 once instead."""
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _ssd_four_steps_f32(x, dt, a, b_mat, c_mat, chunk, init_state=None,
                        split=True):
    """What the chunked body of ``csrc/ssd_scan.cu`` computes on float32
    x, B and C, step for step in the kernel's (B, H, S, P) layout: (1) the
    scores C_c B_c^T once per chunk for all heads; (2) per (chunk, head)
    the delta sum_j (w_j x_j)^T B_j, w_j = exp(seg_last - seg_j) dt_j; (3)
    the state pass, keeping each chunk's entry state; (4) y = exp(seg_i)
    C_i . entry^T + (G o decay o dt) x. Every product through ``_prod``;
    rows past S have dt = 0. Returns (y float32, final state)."""
    b, h, s, p = x.shape
    n = b_mat.shape[-1]
    q, nc = chunk, -(-s // chunk)
    pad = nc * q - s
    xc = F.pad(x, (0, 0, 0, pad)).reshape(b, h, nc, q, p)
    dtc = F.pad(dt, (0, pad)).reshape(b, h, nc, q)
    bc = F.pad(b_mat, (0, 0, 0, pad)).reshape(b, nc, q, n)
    cc = F.pad(c_mat, (0, 0, 0, pad)).reshape(b, nc, q, n)
    seg = torch.cumsum(dtc * a[None, :, None, None], dim=-1)
    last = seg[..., -1:]
    g = _prod("bcin,bcjn->bcij", cc, bc, split)                      # (1)
    wx = torch.exp(last - seg)[..., None] * dtc[..., None] * xc
    delta = _prod("bhcjp,bcjn->bhcpn", wx, bc, split)                # (2)
    state = (torch.zeros(b, h, p, n) if init_state is None
             else init_state.float())
    entry = []
    for c in range(nc):                                              # (3)
        entry.append(state)
        state = state * torch.exp(last[:, :, c])[..., None] + delta[:, :, c]
    y = _prod("bcin,bhcpn->bhcip", cc, torch.stack(entry, dim=2),    # (4)
              split) * torch.exp(seg)[..., None]
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    w = torch.where(causal, g[:, None] * torch.exp(
        seg[..., :, None] - seg[..., None, :]) * dtc[..., None, :], 0.0)
    y = y + _prod("bhcij,bhcjp->bhcip", w, xc, split)
    return y.reshape(b, h, nc * q, p)[:, :, :s], state


def _ssd_inputs(b, h, s, p, n, seed, layout="bhsp"):
    """x, dt (post-softplus), a (< 0), B, C as float32 numpy arrays, the
    SSD tests' distribution, in the kernel's or the model's layout."""
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
    (1, 2, 128, 32, 16, 16),
    (2, 4, 256, 64, 32, 64),
    (1, 1, 64, 16, 8, 64),      # single chunk
    (1, 3, 256, 64, 128, 128),  # mamba2_1_3b's head width, state, chunk
    (1, 4, 256, 64, 16, 64),    # jamba_v0_1_52b's head width, state, chunk
])
def test_f32_four_step_plan_matches_pallas_kernel_and_recurrence(b, h, s, p,
                                                                 n, chunk):
    arrays = _ssd_inputs(b, h, s, p, n, seed=s + n + 1)
    y, st = _ssd_four_steps_f32(*_t(arrays), chunk=chunk)
    want = np.asarray(pallas_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                      interpret=True))
    _close(y, want, SSD_TOL)
    _close(y, np.asarray(ssd_scan_ref(*map(jnp.asarray, arrays))), SSD_TOL)
    y_seq, st_seq = ssd_ref.ssd_scan_sequential(*_t(arrays))
    _close(st, st_seq, SSD_TOL)


@pytest.mark.parametrize("s", [64, 100, 7])
@pytest.mark.parametrize("init", [False, True])
def test_f32_four_step_plan_matches_model_ssd_chunked(s, init):
    # the smoke config's chunk 16: a ragged tail at S 100 and S 7 < chunk,
    # with and without an initial state, final state included
    cfg = get_smoke_config("mamba2_1_3b")
    b, h, p, n = 2, 3, 16, 16
    x, dt, a, bm, cm = _ssd_inputs(b, h, s, p, n, seed=s, layout="bshp")
    s0 = (np.random.default_rng(9).standard_normal((b, h, p, n))
          .astype(np.float32) if init else None)
    y_ref, st_ref = _ssd_chunked(
        cfg, *map(jnp.asarray, (x, dt, a, bm, cm)),
        init_state=None if s0 is None else jnp.asarray(s0))
    y, st = _ssd_four_steps_f32(
        *_t((x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), a, bm, cm)),
        chunk=cfg.ssm_chunk,
        init_state=None if s0 is None else torch.from_numpy(s0))
    _close(y.transpose(1, 2), y_ref, SSD_MODEL_TOL)
    _close(st, st_ref, SSD_MODEL_TOL)


@pytest.mark.parametrize("s,chunk", [(37, 16), (5, 128), (300, 128),
                                     (100, 64), (33, 64)])
def test_f32_four_step_plan_ragged_matches_plain_and_sequential(s, chunk):
    # a ragged last chunk and an initial state: y and the final state
    # against the plain chunked version and the recurrence
    x, dt, a, bm, cm = _t(_ssd_inputs(2, 3, s, 24, 12, seed=s))
    s0 = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (2, 3, 24, 12)).astype(np.float32))
    y, st = _ssd_four_steps_f32(x, dt, a, bm, cm, chunk=chunk, init_state=s0)
    for want_y, want_st in (
            ssd_ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk, init_state=s0),
            ssd_ref.ssd_scan_sequential(x, dt, a, bm, cm, init_state=s0)):
        _close(y, want_y, SSD_TOL)
        _close(st, want_st, SSD_TOL)


def test_one_bf16_rounding_misses_the_ssd_bound():
    # mamba2_1_3b's widths at S 256: rounding each float32 operand to
    # bfloat16 once (2^-9) puts y past 1e-4 of the recurrence; the split
    # stays under a tenth of it
    arrays = _t(_ssd_inputs(1, 3, 256, 64, 128, seed=3))
    want, _ = ssd_ref.ssd_scan_sequential(*arrays)
    scale = max(1.0, float(want.abs().max()))
    once, _ = _ssd_four_steps_f32(*arrays, chunk=128, split=False)
    split, _ = _ssd_four_steps_f32(*arrays, chunk=128)
    err_once = float((once - want).abs().max()) / scale
    err_split = float((split - want).abs().max()) / scale
    assert err_once > SSD_TOL and err_split < SSD_TOL / 10, (err_once,
                                                             err_split)


def test_ssd_f32_entry_takes_the_scratch():
    # both entries run the chunked body on the same scratch: the scores,
    # the deltas, the entry states' hi and lo planes and the decays
    assert ssd_kernel._ENTRY == {torch.float32: "ssd_scan_f32",
                                 torch.bfloat16: "ssd_scan_bf16"}
    assert ssd_kernel.scratch_size(1, 64, 1024, 64, 128, 128) == \
        8 * 128 * 128 + 2 * 8 * 64 * 64 * 128 + 64 * 8
