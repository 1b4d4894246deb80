"""The tile plans of the attention kernels' Hopper bodies at the widths
no earlier body took on the tensor cores, emulated step for step in plain
torch: flash attention at head dim 256 (gemma_2b's) on the TMA + wgmma
body, and grouped decode at groups of 2-16 on the tensor-core body. Each
emulation is held against the port's plain version, the JAX oracles, the
reference model's ``_attend`` and the Pallas kernels in interpret mode.

Inputs come from a numpy seed and are rounded to bfloat16 once, by jax.
Bound: the JAX kernel tests' bfloat16 one, 2e-2 (rtol and atol); the
log-sum-exps 1e-3 in float32 against the plain version's."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import _attend as jax_attend
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ref as flash_ref

TOL = 2e-2
LSE_TOL = 1e-3
LOG2E = math.log2(math.e)
CACHES = {"bfloat16": torch.bfloat16, "e4m3": torch.float8_e4m3fn,
          "e5m2": torch.float8_e5m2}


def _bf16(shapes, seed):
    """numpy draws rounded to bfloat16 by jax: (jax arrays, torch
    tensors) of the same values."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s).astype(np.float32),
                      jnp.bfloat16) for s in shapes]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
          for j in js]
    return js, ts


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# -- flash attention at head dim 256 on the Hopper body ----------------------

def _flash_tiles_d256(q, k, v, causal, bq, window=0, stats=None):
    """What the Hopper body of ``csrc/flash_attention.cu`` computes at head
    dim 256, tile for tile: blocks of ``bq`` query rows, a warpgroup per 64
    of them, kv stages of ``KV_ROWS_D256`` rows up to the block's causal
    limit and from the stage holding its first key q0 - W + 1 with a
    window (asserting that the stages before it are wholly masked); a
    warpgroup skips stages wholly above its rows or wholly below its
    rows' window and masks only stages crossing its diagonal, the end of S
    or its window's lower edge (asserting both); scores of exact bf16
    products summed in float32 times scale log2 e, the online softmax in
    log2 units, P rounded to bfloat16 for P V, the sum of P in float32,
    the output rounded once. Returns (out, lse), lse = m ln 2 + log l."""
    b, s, hq, d = q.shape
    assert d == 256
    bk = flash_kernel.KV_ROWS_D256
    rep = hq // k.shape[2]
    scale_log2 = LOG2E / math.sqrt(d)
    qf = q.float().transpose(1, 2)                              # (B, H, S, D)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
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
        k_first = max(0, q0 - window + 1) // bk * bk if window else 0
        block = torch.arange(q0, min(q0 + bq, s))
        for k0 in range(0, k_first, bk):                # never loaded
            assert not bool(valid_at(block, torch.arange(k0, k0 + bk)).any())
            count("not loaded")
        for first in range(q0, min(q0 + bq, s), 64):
            last = first + 63
            rows = torch.arange(first, min(first + 64, s))
            m = torch.full((b, hq, len(rows), 1), -math.inf)
            l = torch.zeros(b, hq, len(rows), 1)
            acc = torch.zeros(b, hq, len(rows), d)
            for k0 in range(k_first, kv_end, bk):
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
                kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], \
                    vf[:, :, k0:k0 + n]
                sc = qf[:, :, rows] @ kt.transpose(-1, -2) * scale_log2
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
                acc = acc * corr + p.bfloat16().float() @ vt
                m = m_new
            out[:, :, rows] = acc / l.clamp_min(1e-30)
            lse[:, :, rows] = (m * math.log(2)
                               + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


@pytest.mark.parametrize("hq,hkv", [(8, 1), (4, 2)])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 333, 1000])
def test_flash_d256_plan_matches_plain_and_jax(hq, hkv, s):
    # gemma_2b's 8:1 group and a 2:1 group at S one stage's and one
    # warpgroup's edges and ragged; causal and not, each with its lse;
    # held against the plain version and the JAX oracle
    d = 256
    (q, k, v), (tq, tk, tv) = _bf16(
        [(1, s, hq, d), (1, s, hkv, d), (1, s, hkv, d)], seed=s + hq)
    for causal in (True, False):
        stats = {}
        got, lse = _flash_tiles_d256(tq, tk, tv, causal,
                                     flash_kernel.BLOCK_ROWS_D256,
                                     stats=stats)
        assert got.dtype == torch.bfloat16 and got.shape == tq.shape
        plain, plain_lse = flash_ref.flash_attention(
            tq, tk, tv, causal=causal, return_lse=True)
        _close(got, plain)
        _close(lse, plain_lse, LSE_TOL)
        want = attention_ref(*(jnp.swapaxes(a, 1, 2) for a in (q, k, v)),
                             causal=causal)
        _close(got, jnp.swapaxes(want, 1, 2))
        # ragged S and the causal diagonal are the only masked stages
        assert (stats.get("masked", 0) > 0) == (causal or s % 64 != 0)


@pytest.mark.parametrize("window", [1, 40, 256, 700])
def test_flash_d256_plan_with_window(window):
    # S 600 (ragged), gemma_2b's 8:1 group; windows of one key, inside a
    # stage, four stages and past S: the stages before a block's first
    # key are not loaded (the last block's first row lies past W + 63),
    # those crossing the block's lower edge masked, none skipped (a block
    # is one warpgroup); held against the plain version (with its lse) and
    # the reference model's _attend with that window
    s, hq, hkv, d = 600, 8, 1, 256
    bq = flash_kernel.BLOCK_ROWS_D256
    (q, k, v), (tq, tk, tv) = _bf16(
        [(1, s, hq, d), (1, s, hkv, d), (1, s, hkv, d)], seed=window)
    stats = {}
    got, lse = _flash_tiles_d256(tq, tk, tv, True, bq, window, stats)
    plain, plain_lse = flash_ref.flash_attention(tq, tk, tv, window=window,
                                                 return_lse=True)
    _close(got, plain)
    _close(lse, plain_lse, LSE_TOL)
    cfg = dataclasses.replace(get_smoke_config("gemma_2b"),
                              sliding_window=window)
    want = jax_attend(cfg, *(a.astype(jnp.float32) for a in (q, k, v)),
                      q_offset=0)
    _close(got, want)
    assert (stats.get("lower edge", 0) > 0) == (window < s)
    last_block = (s - 1) // bq * bq
    assert (stats.get("not loaded", 0) > 0) == (last_block >= window + 63)
    assert "skipped" not in stats


@pytest.mark.parametrize("hq,hkv", [(8, 1), (4, 2)])
def test_flash_d256_plan_matches_pallas_interpret(hq, hkv):
    # S 256, which the Pallas kernel's 128-row blocks divide; the block
    # size the wrapper picks for it
    b, s, d = 1, 256, 256
    bq = flash_kernel.BLOCK_ROWS_D256
    (q, k, v), (tq, tk, tv) = _bf16(
        [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)], seed=hq + 256)
    got, _ = _flash_tiles_d256(tq, tk, tv, True, bq)
    want = jax_flash_attention(q, k, v, causal=True, block_q=128,
                               block_k=128, interpret=True)
    _close(got, want)


def test_flash_d256_plan_and_body_choice():
    # gemma_2b's bf16 prefills take the Hopper body at head dim 256 in
    # blocks and kv stages of 64 rows; the D 64 / 128 plan's names keep
    # their values; float32 stays on the CUDA-core body
    assert flash_kernel.KV_ROWS == 128 and flash_kernel.BLOCK_ROWS == (64, 128)
    assert 256 in flash_kernel.HOPPER_HEAD_DIMS
    assert flash_kernel.KV_ROWS_D256 == flash_kernel.BLOCK_ROWS_D256 == 64
    q = torch.zeros(1, 8, 8, 256, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 256, dtype=torch.bfloat16)
    assert flash_kernel.takes_hopper_body(q, k, k)
    assert not flash_kernel.takes_hopper_body(q.float(), k.float(),
                                              k.float())
    qkv = torch.zeros(1, 8, 10, 256, dtype=torch.bfloat16)
    assert flash_kernel.takes_hopper_body(qkv[:, :, :8], qkv[:, :, 8:9],
                                          qkv[:, :, 9:])


# -- grouped decode on the tensor cores --------------------------------------

STEP_ROWS = 16          # kv rows of a warp's step
WARPS = 4


def _decode_tc(q, k_cache, v_cache, kv_len, chunk, kv_start=None):
    """What the tensor-core body of ``csrc/decode_attention.cu`` and its
    merge compute, step for step: each (sequence, kv head)'s valid rows
    [first, n) in chunks of ``chunk``; a chunk's rows in steps of 16, step
    i to warp i % 4; each warp's online softmax over its steps (scores of
    exact bf16 products summed in float32 times scale log2 e, log2 units,
    P rounded to bfloat16 for P V, the sum of P in float32, rows past the
    chunk -inf); the warps merged into one float32 partial a chunk, the
    partials merged by their log-sum-exp, the output rounded once to bf16.
    Returns (out, lse), lse -inf where no row is valid (out 0)."""
    b, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    qscale = LOG2E / math.sqrt(d)
    qg = q.float().reshape(b, hkv, rep, d)
    kf, vf = k_cache.float(), v_cache.float()
    out = torch.zeros(b, hkv, rep, d)
    lse = torch.full((b, hkv, rep), -math.inf)
    for i in range(b):
        n = min(max(int(kv_len[i]), 0), s_max)
        first = 0 if kv_start is None else min(max(int(kv_start[i]), 0), n)
        for g in range(hkv):
            parts = []
            for c in range(-(-s_max // chunk)):
                r0, r1 = max(c * chunk, first), min(c * chunk + chunk, n)
                if r0 >= r1:                   # the block exits at once
                    continue
                warps = []
                for w in range(WARPS):
                    m = torch.full((rep,), -math.inf)
                    l = torch.zeros(rep)
                    acc = torch.zeros(rep, d)
                    for row0 in range(r0 + w * STEP_ROWS, r1,
                                      WARPS * STEP_ROWS):
                        rows = torch.arange(row0, row0 + STEP_ROWS)
                        kt = torch.zeros(STEP_ROWS, d)
                        vt = torch.zeros(STEP_ROWS, d)
                        nv = min(STEP_ROWS, r1 - row0)   # zeros past it
                        kt[:nv] = kf[i, row0:row0 + nv, g]
                        vt[:nv] = vf[i, row0:row0 + nv, g]
                        sc = (qg[i, g] @ kt.T) * qscale
                        sc = sc.masked_fill(rows[None, :] >= r1, -math.inf)
                        m_new = torch.maximum(m, sc.amax(-1))
                        corr = torch.exp2(m - m_new)
                        p = torch.exp2(sc - m_new[:, None])
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[:, None] + p.bfloat16().float() @ vt
                        m = m_new
                    warps.append((m, l, acc))
                mm = torch.stack([wm for wm, _, _ in warps]).amax(0)
                num = sum(torch.exp2(wm - mm)[:, None] * a
                          for wm, _, a in warps)
                den = sum(torch.exp2(wm - mm) * wl for wm, wl, _ in warps)
                parts.append((mm, den, num))
            if not parts:
                continue
            mm = torch.stack([pm for pm, _, _ in parts]).amax(0)
            num = sum(torch.exp2(pm - mm)[:, None] * a for pm, _, a in parts)
            den = sum(torch.exp2(pm - mm) * pl for pm, pl, _ in parts)
            out[i, g] = num / den[:, None]
            lse[i, g] = (mm + torch.log2(den)) / LOG2E
    return out.reshape(b, hq, d).to(q.dtype), lse.reshape(b, hq)


def _decode_inputs(b, s_max, hq, hkv, d, cache, seed):
    """q (bf16) and the caches in ``cache``: jax arrays of the values the
    port's tensors hold (float8 caches as their exact float32 values)."""
    (q, kc, vc), (tq, tkc, tvc) = _bf16(
        [(b, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)], seed)
    tkc, tvc = tkc.to(CACHES[cache]), tvc.to(CACHES[cache])
    if cache != "bfloat16":
        kc, vc = (jnp.asarray(t.float().numpy()) for t in (tkc, tvc))
    return (q, kc, vc), (tq, tkc, tvc)


@pytest.mark.parametrize("rep", [2, 5, 6, 8, 16])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("cache", sorted(CACHES))
def test_decode_tc_plan_matches_plain_and_jax(rep, d, cache):
    # groups of 2 (qwen3_1_7b's), 5, 6, 8, 16 over bf16, e4m3 and e5m2
    # caches; lengths 0, 1, a chunk's edge and one past it, a warp's step's
    # edge, the whole cache and past it; the tensor-core body's chunk
    # (chunk_rows_tc) and one of 256 rows (several steps a warp); held
    # against the plain version (with its lse) and the JAX oracle at each
    # sequence's length
    b, s_max, hkv = 7, 300, 2
    hq = rep * hkv
    (q, kc, vc), (tq, tkc, tvc) = _decode_inputs(b, s_max, hq, hkv, d, cache,
                                                 seed=rep * d)
    for chunk in (decode_kernel.chunk_rows_tc(b, s_max, hkv, d), 256):
        lens = np.array([0, 1, chunk, chunk + 1, 16 * 5 + 3, s_max,
                         s_max + 9], np.int32)
        got, lse = _decode_tc(tq, tkc, tvc, torch.from_numpy(lens), chunk)
        assert got.dtype == torch.bfloat16 and got.shape == (b, hq, d)
        plain, plain_lse = decode_ref.decode_attention(
            tq, tkc, tvc, torch.from_numpy(lens), return_lse=True)
        _close(got, plain)
        _close(lse, plain_lse, LSE_TOL)
        assert not got[0].float().any() and bool(torch.isinf(lse[0]).all())
        for i, n in enumerate(lens):
            if n == 0:
                continue
            want = decode_attention_ref(
                jnp.asarray(q[i:i + 1], jnp.float32).reshape(1, hkv, rep, d),
                jnp.swapaxes(jnp.asarray(kc[i:i + 1], jnp.float32), 1, 2),
                jnp.swapaxes(jnp.asarray(vc[i:i + 1], jnp.float32), 1, 2),
                int(n))
            _close(got[i], want.reshape(hq, d))


@pytest.mark.parametrize("rep,d", [(5, 128), (8, 256)])
@pytest.mark.parametrize("cache", ["bfloat16", "e4m3"])
def test_decode_tc_plan_with_first_rows(rep, d, cache):
    # first rows 0, inside the first step, past whole chunks (which then
    # write no partial), on a step's edge, equal to the length (no row)
    # and past it; held against the plain version and the reference
    # model's masked _attend on the rows [first, length)
    b, s_max, hkv = 7, 200, 1
    hq = rep * hkv
    chunk = decode_kernel.chunk_rows_tc(b, s_max, hkv, d)
    (q, kc, vc), (tq, tkc, tvc) = _decode_inputs(b, s_max, hq, hkv, d, cache,
                                                 seed=rep + d)
    lens = np.array([200, 63, 130, 200, 40, 40, 70], np.int32)
    starts = np.array([0, 3, 2 * chunk + 1, 16, 40, 55, 69], np.int32)
    got, lse = _decode_tc(tq, tkc, tvc, torch.from_numpy(lens), chunk,
                          torch.from_numpy(starts))
    plain, plain_lse = decode_ref.decode_attention(
        tq, tkc, tvc, torch.from_numpy(lens),
        kv_start=torch.from_numpy(starts), return_lse=True)
    _close(got, plain)
    _close(lse, plain_lse, LSE_TOL)
    empty = starts >= lens
    assert not got[empty].float().any() and bool(torch.isinf(
        lse[empty]).all())
    rows = np.arange(s_max)[None, :]
    valid = (rows >= starts[:, None]) & (rows < lens[:, None])
    cfg = get_smoke_config("qwen3_1_7b")
    want = jax_attend(cfg, jnp.asarray(q, jnp.float32)[:, None],
                      jnp.asarray(kc, jnp.float32),
                      jnp.asarray(vc, jnp.float32), q_offset=s_max,
                      kv_len_mask=jnp.asarray(valid))[:, 0]
    _close(_f32(got)[~empty], _f32(want)[~empty])


@pytest.mark.parametrize("hq,hkv,d", [(40, 8, 128), (8, 1, 256)])
def test_decode_tc_plan_matches_pallas_interpret(hq, hkv, d):
    # qwen2_5_32b's groups of 5 and gemma_2b's 8 at head dim 256, a length
    # on a chunk's edge of the wrapper's own chunk, the Pallas kernel in
    # interpret mode with the same length
    b, s_max = 2, 256
    chunk = decode_kernel.chunk_rows_tc(b, s_max, hkv, d)
    (q, kc, vc), (tq, tkc, tvc) = _bf16(
        [(b, 1, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)], seed=hq)
    got, _ = _decode_tc(tq[:, 0], tkc, tvc, torch.tensor([chunk, chunk]),
                        chunk)
    want = jax_decode_attention(q, kc, vc, jnp.int32(chunk),
                                num_kv_heads=hkv, block_k=64, interpret=True)
    _close(got, want[:, 0])


def test_decode_tc_body_choice():
    # a bf16 q at groups of 2-16, head dims 64 / 128 / 256, over bf16 or
    # float8 caches with 16-byte rows takes the tensor-core body; groups of
    # 1, a float32 q, other head dims and rows cp.async cannot copy 16
    # bytes at a time keep the CUDA-core body; the split plan's names keep
    # their values
    assert decode_kernel.chunk_rows(8, 2048, 8) == 256
    # the tensor-core body's chunks: chunk_rows's up to head dim 128; at
    # 256 (one 143 KB block an SM) four times as long where that keeps
    # more than a wave of blocks (gemma_2b's one kv head)
    for b, s_max, hkv in ((8, 2048, 8), (1, 32768, 8), (3, 100, 2)):
        for d in (64, 128):
            assert decode_kernel.chunk_rows_tc(b, s_max, hkv, d) == \
                decode_kernel.chunk_rows(b, s_max, hkv)
    assert decode_kernel.chunk_rows_tc(8, 2048, 1, 256) == 128
    assert decode_kernel.chunk_rows_tc(1, 32768, 1, 256) == 256
    assert decode_kernel.chunk_rows_tc(8, 2048, 8, 256) == 1024
    assert (decode_kernel.MIN_CHUNK, decode_kernel.TARGET_BLOCKS,
            decode_kernel.MAX_GROUP) == (64, 528, 16)
    assert decode_kernel.TC_MIN_GROUP == 2

    def takes(hq, hkv, d, qdt=torch.bfloat16, cdt=torch.bfloat16, rows=8):
        q = torch.zeros(2, hq, d, dtype=qdt)
        kc = torch.zeros(2, rows, hkv, d, dtype=cdt)
        return decode_kernel.takes_tensor_cores(q, kc, kc)
    for hq, hkv in ((16, 8), (24, 8), (32, 8), (40, 8), (48, 8), (64, 8),
                    (8, 1), (32, 2)):
        assert takes(hq, hkv, 128) and takes(hq, hkv, 256)
        for cdt in (torch.float8_e4m3fn, torch.float8_e5m2):
            assert takes(hq, hkv, 128, cdt=cdt)
        assert not takes(hq, hkv, 128, qdt=torch.float32)
        assert not takes(hq, hkv, 128, qdt=torch.float32,
                         cdt=torch.bfloat16)
        assert not takes(hq, hkv, 96)
    assert takes(40, 8, 64)
    for hq, hkv in ((8, 8), (32, 32), (1, 1)):
        assert not takes(hq, hkv, 128) and not takes(hq, hkv, 64)
    # a (B, S, Hkv + pad, D) cache's view: strides still whole chunks
    padded = torch.zeros(2, 8, 3, 128, dtype=torch.bfloat16)
    q = torch.zeros(2, 10, 128, dtype=torch.bfloat16)
    assert decode_kernel.takes_tensor_cores(q, padded[:, :, :2],
                                            padded[:, :, 1:])
    # rows 8 bytes off a 16-byte chunk
    odd = torch.zeros(2, 8, 2, 132, dtype=torch.bfloat16)[..., 4:]
    assert not decode_kernel.takes_tensor_cores(q, odd, odd)
