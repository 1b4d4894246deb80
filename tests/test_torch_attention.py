"""The port's attention kernels' plain versions
(``repro_torch/kernels/{flash,decode}_attention/ref.py``, which the
wrappers take for CPU tensors) against the JAX reference: the Pallas
kernels in interpret mode, their jnp oracles, and the model's ``_attend``.

Inputs come from a numpy seed. Bounds: float32 2e-5 and bfloat16 2e-2
(rtol and atol), the JAX kernel tests' own (tests/test_kernel_flash_
attention.py); against the model's ``_attend`` 3e-5, that file's bound for
the same comparison."""
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
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.attention import _attend as torch_attend

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    """The same values as jax and torch arrays of ``dtype`` (rounded once,
    by jax, so both packages see identical bf16 inputs)."""
    js = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
          for j in js]
    return js, ts


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


FLASH_CASES = [
    # b, s, hq, hkv, d, block
    (1, 128, 4, 2, 16, 64),      # GQA 2:1, the smoke config's head dim
    (2, 128, 4, 4, 64, 64),      # MHA
    (1, 128, 4, 1, 128, 64),     # MQA, head dim 128
    (1, 64, 16, 8, 128, 64),     # qwen3_1_7b's heads and head dim
]


@pytest.mark.parametrize("b,s,hq,hkv,d,block", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_interpret(b, s, hq, hkv, d, block,
                                              dtype):
    (q, k, v), (tq, tk, tv) = _both(
        _arrays([(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)], seed=d + s),
        dtype)
    got = flash_ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == TDT[dtype] and got.shape == (b, s, hq, d)
    want = jax_flash_attention(q, k, v, causal=True, block_q=block,
                               block_k=block, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("s,hq,hkv,d,dtype,causal", [
    (s, hq, hkv, d, dtype, True)
    for s, hq, hkv, d in ((1, 4, 2, 16), (37, 8, 1, 64), (100, 16, 8, 128))
    for dtype in ("float32", "bfloat16")] + [(37, 4, 2, 16, "float32", False)])
def test_flash_plain_matches_oracle_ragged(s, hq, hkv, d, dtype, causal):
    # ragged lengths the TPU kernel's blocks cannot take (S % block != 0)
    (q, k, v), (tq, tk, tv) = _both(
        _arrays([(2, s, hq, d), (2, s, hkv, d), (2, s, hkv, d)], seed=s),
        dtype)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal)
    want = attention_ref(*(jnp.swapaxes(a, 1, 2) for a in (q, k, v)),
                         causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(jnp.swapaxes(want, 1, 2)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("s", [16, 45])
def test_flash_plain_matches_model_attend(s):
    cfg = get_smoke_config("qwen3_1_7b")
    (q, k, v), (tq, tk, tv) = _both(
        _arrays([(2, s, 4, 16), (2, s, 2, 16), (2, s, 2, 16)], seed=7),
        "float32")
    got = flash_ops.flash_attention(tq, tk, tv)
    want = jax_attend(cfg, q, k, v, q_offset=0)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-5, atol=3e-5)
    # the port's own copy of _attend, the third implementation
    np.testing.assert_allclose(_f32(torch_attend(cfg, tq, tk, tv, 0)),
                               _f32(want), rtol=3e-5, atol=3e-5)


DECODE_CASES = [
    # b, s_max, hq, hkv, d, kv_len
    (2, 64, 4, 2, 16, 37),
    (3, 128, 8, 1, 64, 128),
    (2, 128, 16, 8, 128, 65),
    (1, 64, 4, 4, 32, 1),
]


@pytest.mark.parametrize("b,s_max,hq,hkv,d,kv_len", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_interpret(b, s_max, hq, hkv, d, kv_len,
                                               dtype):
    (q, kc, vc), (tq, tkc, tvc) = _both(
        _arrays([(b, 1, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)],
                seed=kv_len), dtype)
    got = decode_ops.decode_attention(tq, tkc, tvc, torch.tensor(kv_len))
    assert got.shape == (b, 1, hq, d) and got.dtype == TDT[dtype]
    want = jax_decode_attention(q, kc, vc, jnp.int32(kv_len),
                                num_kv_heads=hkv, block_k=32, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    rep = hq // hkv
    oracle = decode_attention_ref(q[:, 0].reshape(b, hkv, rep, d),
                                  jnp.swapaxes(kc, 1, 2),
                                  jnp.swapaxes(vc, 1, 2), kv_len)
    np.testing.assert_allclose(_f32(got), _f32(oracle.reshape(b, 1, hq, d)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 16), (16, 8, 128)])
def test_decode_plain_matches_model_attend_per_row(hq, hkv, d):
    # one length per sequence, as the model's decode step gives: pos 0
    # (kv_len 1), mid-cache, the last slot, and two past the cache (the
    # reference writes nothing there and reads the whole row)
    cfg = get_smoke_config("qwen3_1_7b")
    s_max = 24
    pos = np.array([0, 9, s_max - 1, s_max, s_max + 5], np.int32)
    b = len(pos)
    (q, kc, vc), (tq, tkc, tvc) = _both(
        _arrays([(b, 1, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)],
                seed=3), "float32")
    kv_len = np.minimum(pos + 1, s_max)
    got = decode_ops.decode_attention(tq, tkc, tvc,
                                      torch.from_numpy(kv_len))
    valid = jnp.arange(s_max)[None, :] <= jnp.asarray(pos)[:, None]
    want = jax_attend(cfg, q, kc, vc, q_offset=int(pos.max()),
                      kv_len_mask=valid)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-5, atol=3e-5)
    # lengths past the cache are clamped by the op itself
    got_unclamped = decode_ops.decode_attention(
        tq, tkc, tvc, torch.from_numpy(pos + 1))
    np.testing.assert_array_equal(_f32(got_unclamped), _f32(got))


def test_decode_plain_zero_length_gives_zeros():
    (tq, tkc, tvc) = [torch.from_numpy(a) for a in _arrays(
        [(2, 1, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16)], seed=1)]
    out = decode_ops.decode_attention(tq, tkc, tvc, torch.tensor([0, 3]))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all() and out[1].abs().sum() > 0


# -- the split-KV plan of the Hopper decode kernel, emulated in plain torch --

from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ref as decode_ref  # noqa: E402


def _split_kv(q, k_cache, v_cache, kv_len, chunk):
    """What ``csrc/decode_attention.cu`` computes, step for step: each
    (sequence, kv head)'s valid rows in chunks of ``chunk``, one float32
    partial (max, sum, unnormalised accumulator) per chunk that holds a
    valid row, then the partials merged by their log-sum-exp; a length of
    0 leaves no partial and gives zeros."""
    b, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    qg = q.float().reshape(b, hkv, rep, d) / math.sqrt(d)
    out = torch.zeros(b, hkv, rep, d)
    for i in range(b):
        n = min(max(int(kv_len[i]), 0), s_max)
        parts = []
        for r0 in range(0, n, chunk):
            kc = k_cache[i, r0:min(r0 + chunk, n)].float()   # (rows, Hkv, D)
            vc = v_cache[i, r0:min(r0 + chunk, n)].float()
            s = torch.einsum("hrd,jhd->hrj", qg[i], kc)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("hrj,jhd->hrd", p, vc)))
        if not parts:
            continue
        mm = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        num = sum(torch.exp(m - mm) * a for m, _, a in parts)
        den = sum(torch.exp(m - mm) * l for m, l, _ in parts)
        out[i] = num / den
    return out.reshape(b, hq, d).to(q.dtype)


@pytest.mark.parametrize("chunk", [7, 32, 64, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_kv_plan_matches_plain_and_jax(chunk, dtype):
    # lengths 0, 1, a chunk boundary and one past it, S_max and past it
    b, s_max, hq, hkv, d = 7, 100, 8, 2, 32
    lens = np.array([0, 1, chunk, chunk + 1, 63, s_max, s_max + 9],
                    np.int32)
    (q, kc, vc), (tq, tkc, tvc) = _both(
        _arrays([(b, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)],
                seed=chunk), dtype)
    got = _split_kv(tq, tkc, tvc, torch.from_numpy(lens), chunk)
    assert got.dtype == TDT[dtype]
    plain = decode_ref.decode_attention(tq, tkc, tvc, torch.from_numpy(lens))
    np.testing.assert_allclose(_f32(got), _f32(plain), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert not got[0].float().any()
    rep = hq // hkv
    for i, n in enumerate(lens):
        if n == 0:
            continue
        want = decode_attention_ref(q[i:i + 1].reshape(1, hkv, rep, d),
                                    jnp.swapaxes(kc[i:i + 1], 1, 2),
                                    jnp.swapaxes(vc[i:i + 1], 1, 2), int(n))
        np.testing.assert_allclose(_f32(got[i]), _f32(want.reshape(hq, d)),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_split_kv_plan_matches_pallas_interpret_at_serving_heads():
    # qwen3_1_7b's heads, a length on a chunk boundary of the wrapper's
    # own chunk, the Pallas kernel in interpret mode with the same length
    b, s_max, hq, hkv, d = 2, 256, 16, 8, 128
    chunk = decode_kernel.chunk_rows(b, s_max, hkv)
    (q, kc, vc), (tq, tkc, tvc) = _both(
        _arrays([(b, 1, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)],
                seed=11), "float32")
    got = _split_kv(tq[:, 0], tkc, tvc, torch.tensor([chunk, chunk]), chunk)
    want = jax_decode_attention(q, kc, vc, jnp.int32(chunk),
                                num_kv_heads=hkv, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want[:, 0]), rtol=TOL[
        "float32"], atol=TOL["float32"])


def test_split_kv_chunks_fill_the_card():
    # the serving shape (8 slots x 2,048 rows, 8 kv heads): more than the
    # 132 SMs' worth of blocks; one long sequence splits finer
    for b, s_max, hkv in ((8, 2048, 8), (1, 32768, 8), (1, 2048, 8),
                          (3, 100, 2)):
        chunk = decode_kernel.chunk_rows(b, s_max, hkv)
        blocks = b * hkv * -(-s_max // chunk)
        assert chunk >= decode_kernel.MIN_CHUNK and chunk & (chunk - 1) == 0
        assert blocks <= decode_kernel.TARGET_BLOCKS \
            or chunk == decode_kernel.MIN_CHUNK
        if b * hkv * s_max >= 132 * decode_kernel.MIN_CHUNK:
            assert blocks > 132, (b, s_max, hkv, chunk)
    assert decode_kernel.chunk_rows(8, 2048, 8) == 256


# -- the tile plan of the Hopper flash body, emulated in plain torch ---------

from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402


def _flash_tiles(q, k, v, causal, bq, bk):
    """What the Hopper body of ``csrc/flash_attention.cu`` computes, tile
    for tile: blocks of ``bq`` query rows, a warpgroup per 64 of them, kv
    tiles of ``bk`` rows up to the block's causal limit; a warpgroup skips
    the tiles wholly above its rows and tests the mask only on tiles that
    cross its diagonal or the end of S (asserting that every other tile
    needs no mask); online softmax in the log2 domain in float32, P
    rounded to bfloat16 for P V, the output rounded once."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    scale_log2 = 1.0 / math.sqrt(d) * math.log2(math.e)
    qf = q.float().transpose(1, 2)                              # (B, H, S, D)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    out = torch.zeros(b, hq, s, d)
    for q0 in range(0, s, bq):
        kv_end = min(s, q0 + bq) if causal else s
        for first in range(q0, min(q0 + bq, s), 64):
            last = first + 63
            rows = torch.arange(first, min(first + 64, s))
            m = torch.full((b, hq, len(rows), 1), -math.inf)
            l = torch.zeros(b, hq, len(rows), 1)
            acc = torch.zeros(b, hq, len(rows), d)
            for k0 in range(0, kv_end, bk):
                if causal and k0 > last:
                    continue
                cols = torch.arange(k0, k0 + bk)
                kt = torch.zeros(b, hq, bk, d)
                vt = torch.zeros(b, hq, bk, d)
                n = min(bk, s - k0)        # rows past S arrive as zeros
                kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], \
                    vf[:, :, k0:k0 + n]
                sc = qf[:, :, rows] @ kt.transpose(-1, -2) * scale_log2
                valid = (cols[None, :] < s) & (
                    ~torch.tensor(causal) | (cols[None, :] <= rows[:, None]))
                if (causal and k0 + bk - 1 > first) or k0 + bk > s:
                    sc = sc.masked_fill(~valid, -math.inf)
                else:
                    assert bool(valid.all()), (q0, first, k0)
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                base = torch.where(m_new == -math.inf, 0.0, m_new)
                corr = torch.exp2(m - base)
                p = torch.exp2(sc - base)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.bfloat16().float() @ vt
                m = m_new
            out[:, :, rows] = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("bq", flash_kernel.BLOCK_ROWS)
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("edge", ["1", "63", "64", "65", "bk-1", "bk",
                                  "bk+1", "1000"])
def test_flash_tile_plan_matches_plain_and_jax(bq, rep, edge):
    # S at a warpgroup's and the kv tile's edges and a ragged 1,000; GQA
    # 1:1, 2:1, 4:1; held against the plain version and the JAX oracle at
    # the bf16 bound
    bk = flash_kernel.KV_ROWS
    s = {"1": 1, "bk-1": bk - 1, "bk": bk, "bk+1": bk + 1,
         "1000": 1000}.get(edge) or int(edge)
    hkv, d = 2, 64
    hq = hkv * rep
    (q, k, v), (tq, tk, tv) = _both(
        _arrays([(1, s, hq, d), (1, s, hkv, d), (1, s, hkv, d)],
                seed=s + rep), "bfloat16")
    for causal in (True, False):
        got = _flash_tiles(tq, tk, tv, causal, bq, bk)
        assert got.dtype == torch.bfloat16 and got.shape == tq.shape
        plain = flash_ref.flash_attention(tq, tk, tv, causal=causal)
        np.testing.assert_allclose(_f32(got), _f32(plain),
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
        want = attention_ref(*(jnp.swapaxes(a, 1, 2) for a in (q, k, v)),
                             causal=causal)
        np.testing.assert_allclose(_f32(got), _f32(jnp.swapaxes(want, 1, 2)),
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_flash_tile_plan_matches_pallas_interpret(hq, hkv):
    # qwen3_1_7b's head dim, two kv tiles of the wrapper's plan
    b, s, d = 1, 256, 128
    bq, bk = flash_kernel.block_rows(b, s, hq), flash_kernel.KV_ROWS
    (q, k, v), (tq, tk, tv) = _both(
        _arrays([(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)], seed=hq),
        "bfloat16")
    got = _flash_tiles(tq, tk, tv, True, bq, bk)
    want = jax_flash_attention(q, k, v, causal=True, block_q=128,
                               block_k=128, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


def test_flash_plan_and_body_choice():
    # the serving path's prompts (B 1, 16 query heads, S 128..1,024): the
    # block size is a compiled one, 64 rows while the blocks fit one wave;
    # bf16 at head dims 64 and 128 on 16-byte-aligned rows takes the
    # Hopper body, the rest the CUDA cores
    for s in (1, 128, 333, 512, 1000, 1024, 4096):
        bq = flash_kernel.block_rows(1, s, 16)
        assert bq in flash_kernel.BLOCK_ROWS
        assert (bq == 64) == (16 * -(-s // 64) <= flash_kernel.SMS)
    q = torch.zeros(1, 8, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    assert flash_kernel.takes_hopper_body(q, k, k)
    assert flash_kernel.takes_hopper_body(q[..., :64].contiguous(),
                                          k[..., :64].contiguous(),
                                          k[..., :64].contiguous())
    assert not flash_kernel.takes_hopper_body(q.float(), k.float(),
                                              k.float())
    assert not flash_kernel.takes_hopper_body(
        q[..., :32].contiguous(), k[..., :32].contiguous(),
        k[..., :32].contiguous())
    wide = torch.zeros(1, 8, 4, 129, dtype=torch.bfloat16)
    assert not flash_kernel.takes_hopper_body(wide[..., 1:], k, k)
    # a fused (B, S, Hq + 2 Hkv, D) projection's views: the model's layout
    qkv = torch.zeros(1, 8, 8, 128, dtype=torch.bfloat16)
    assert flash_kernel.takes_hopper_body(qkv[:, :, :4], qkv[:, :, 4:6],
                                          qkv[:, :, 6:])
