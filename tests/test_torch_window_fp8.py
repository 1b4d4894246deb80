"""Sliding-window attention and the float8 KV cache in the port against the
JAX reference, on the CPU (the kernels' plain versions), on inputs drawn
from a numpy seed and the reference's params carried across with
``convert.params_from_numpy``:

  * ``common.to_cache_dtype_torch`` writes a cache bit for bit as the
    reference's ``astype`` (both float8 dtypes, from float32 and bfloat16,
    overflowing values and NaN included; torch's own cast does not);
  * the plain flash with a window against the reference's ``_attend`` and
    ``_make_flash_train`` forward, and its FLOP formula against the count
    of windowed pairs;
  * the plain decode with a first valid row and float8 caches against the
    reference's masked ``_attend``;
  * qwen3_1_7b's smoke model with W 4 and an e4m3 cache: prefill, and
    decode steps at staggered positions (a slot whose window holds no row
    among them), logits against ``forward_decode`` and cache bytes bit for
    bit; its ``ServingEngine`` against the reference engine's tokens;
  * training with a window: loss and every gradient against
    ``forward_train`` (through ``_FlashTrain`` and ``_attend``), and
    ``_FlashTrain``'s gradients against ``_make_flash_train``'s custom VJP
    at TestFlashVJP's (4, 4, 48) case;
  * the sharded decode (4 gloo ranks, cache sharded on the sequence and
    on the batch only) with the window and an e4m3 cache.

Bounds: float32 1e-4 (times max(1, max|ref|) for logits and gradients),
as the model tests; cache bytes and engine tokens exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import (forward_decode, forward_prefill, init_caches,
                          init_params)
from repro.models.attention import _attend as jax_attend
from repro.models.attention import _flash_fwd_scan, _make_flash_train
from repro.serve import ServingEngine as RefEngine
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.launch import collectives as col
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from repro_torch.models.common import to_cache_dtype_torch
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import load_params, params_from_numpy
from repro_torch.serve import ServingEngine
from test_torch_train_model import check_train, close, make_batch
from torch_gloo import run_gloo_ranks

BOUND = 1e-4
FP8 = ("float8_e4m3fn", "float8_e5m2")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float8_e4m3fn": jnp.float8_e4m3fn, "float8_e5m2": jnp.float8_e5m2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}
TDT_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
#: the window and cache of the smoke model's decode, prefill and engine
WINDOW, CACHE = 4, "float8_e4m3fn"


def _port(cfg):
    return PortConfig(**dataclasses.asdict(cfg))


def _windowed(window=WINDOW, cache=CACHE, **kw):
    return dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                               sliding_window=window, cache_dtype=cache,
                               **kw)


def _carried(cfg, seed=0):
    params = init_params(cfg, jax.random.PRNGKey(seed))
    return params, load_params(_port(cfg), params_from_numpy(
        _port(cfg), jax.tree.map(np.asarray, params)), device="cpu")


def _bytes(x):
    return (x.view(torch.uint8).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).view(np.uint8))


def _near(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = BOUND * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err:.3e} > bound {bound:.3e}"


# -- the cache cast ------------------------------------------------------------

_EDGES = [0.0, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10, 2.0 ** -16, 2.0 ** -17,
          1e-3, 0.3, 448.0, 464.0, 465.0, 480.0, 500.0, 57344.0, 61440.0,
          1e6, np.inf]
CAST_VALUES = np.array(_EDGES + [-x for x in _EDGES] + [np.nan, -np.nan],
                       np.float32)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("fp8", FP8)
def test_cache_cast_matches_astype_bit_for_bit(src, fp8):
    x = jnp.asarray(CAST_VALUES).astype(JDT[src])
    want = _bytes(x.astype(JDT[fp8]))
    # the same input bits in torch
    bits = np.asarray(x).view(np.int16 if src == "bfloat16" else np.int32)
    xt = torch.from_numpy(bits.copy()).view(TDT[src])
    got = to_cache_dtype_torch(xt, TDT[fp8])
    assert got.dtype == TDT[fp8]
    np.testing.assert_array_equal(_bytes(got), want)
    if fp8 == "float8_e4m3fn":
        # torch's own cast saturates there (P18)
        assert (_bytes(xt.to(TDT[fp8])) != want).any()
    # other dtypes: a plain cast
    assert torch.equal(
        to_cache_dtype_torch(xt, torch.float32).view(torch.int32),
        xt.float().view(torch.int32))


# -- flash with a window ---------------------------------------------------------

def _qkv(shapes, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return arrays, [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window", [1, 48, 128])
def test_flash_window_matches_reference(window):
    b, s, hq, hkv, d = 2, 128, 4, 2, 16
    (q, k, v), (tq, tk, tv) = _qkv(
        [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)], seed=window)
    got, lse = flash_kernel.flash_attention(tq, tk, tv, window=window,
                                            return_lse=True)
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              sliding_window=window)
    _near(got, jax_attend(cfg, q, k, v, q_offset=0), "flash vs _attend")
    _near(got, _make_flash_train(32, window)(q, k, v),
          "flash vs _make_flash_train")
    want_out, want_lse = _flash_fwd_scan(32, window, q, k, v)
    _near(lse, np.asarray(want_lse).reshape(b, hq, s), "lse")
    _near(tattention._attend(_port(cfg), tq, tk, tv, 0), want_out,
          "the port's _attend")


@pytest.mark.parametrize("window,s", [(1, 33), (5, 33), (32, 33), (40, 33),
                                      (4096, 8192)])
def test_flash_window_flops_count_the_windowed_pairs(window, s):
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, hq, hkv, d = 2, 4, 2, 8
    with FakeTensorMode():
        q = torch.empty(b, s, hq, d)
        k = torch.empty(b, s, hkv, d)
        rec = col.TraceRecorder()
        with rec:
            flash_kernel.flash_attention(q, k, k, window=window)
    i = np.arange(s)
    pairs = int(np.minimum(i + 1, window).sum())
    assert flash_kernel.attended_pairs_np(s, True, window) == pairs
    assert rec.flops == 4 * b * hq * d * pairs
    if window < s:
        assert pairs < s * (s + 1) // 2


@pytest.mark.parametrize("cache", [torch.bfloat16, *TDT_FP8])
def test_decode_trace_counts_the_cache_at_its_element_size(cache):
    # the dry run's memory term: the decode operator reads each cache
    # value once, one byte a float8 value
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, s_max, hq, hkv, d = 2, 64, 4, 2, 16
    with FakeTensorMode():
        q = torch.empty(b, 1, hq, d, dtype=torch.bfloat16)
        kc = torch.empty(b, s_max, hkv, d, dtype=cache)
        n = torch.empty(b, dtype=torch.int32)
        rec = col.TraceRecorder()
        with rec:
            decode_ops.decode_attention(q, kc, kc, n, kv_start=n)
    el = torch.tensor([], dtype=cache).element_size()
    assert rec.ops["repro_torch.decode_attention_plain"][1] == 1
    assert rec.bytes_accessed == (2 * b * s_max * hkv * d * el
                                  + 2 * b * hq * d * 2 + 2 * b * 4)


def test_flash_window_needs_causal():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="causal"):
        flash_kernel.flash_attention(q, q, q, causal=False, window=2)
    with pytest.raises(ValueError, match="window"):
        flash_kernel.flash_attention(q, q, q, window=-1)


# -- decode: a first valid row and float8 caches --------------------------------

@pytest.mark.parametrize("cache", ["float32"] + list(FP8))
def test_decode_first_rows_and_fp8_match_reference(cache):
    # the model's decode rows: the window measured from the batch's largest
    # position P, rows (P - W, pos_b]; pos 4 keeps no row (the reference
    # then weighs every row alike, checked on the model below)
    b, s_max, hq, hkv, d, window = 6, 40, 4, 2, 16, 9
    pos = np.array([30, 29, 25, 22, 35, 4], np.int32)
    (q, kc, vc), _ = _qkv([(b, 1, hq, d), (b, s_max, hkv, d),
                           (b, s_max, hkv, d)], seed=5)
    kj, vj = (jnp.asarray(a).astype(JDT[cache]) for a in (kc, vc))
    tk, tv = (to_cache_dtype_torch(torch.from_numpy(a), TDT[cache])
              for a in (kc, vc))
    np.testing.assert_array_equal(_bytes(tk), _bytes(kj))
    first = np.full(b, pos.max() + 1 - window, np.int32)
    got, lse = decode_ops.decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pos + 1),
        kv_start=torch.from_numpy(first), return_lse=True)
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              sliding_window=window)
    valid = jnp.arange(s_max)[None, :] <= jnp.asarray(pos)[:, None]
    want = jax_attend(cfg, jnp.asarray(q), kj, vj, q_offset=int(pos.max()),
                      kv_len_mask=valid)
    keep = pos + 1 > first
    _near(got.numpy()[keep], np.asarray(want)[keep], f"decode, {cache}")
    assert not got[~keep].any() and torch.isneginf(lse[~keep]).all()
    assert torch.isfinite(lse[keep]).all()


# -- the smoke model -----------------------------------------------------------------

def test_model_prefill_with_window_matches_reference():
    cfg = _windowed()
    params, model = _carried(cfg)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    lj, cj = jax.jit(lambda p, t: forward_prefill(cfg, p, t))(
        params, jnp.asarray(tokens))
    lt, ct = tmodel.forward_prefill(_port(cfg), model,
                                    torch.from_numpy(tokens), device="cpu")
    _near(lt.numpy(), np.asarray(lj), "prefill logits")
    for layer in range(cfg.num_layers):
        for key in ("k", "v"):
            assert ct[layer][key].dtype == torch.float32   # compute dtype
            _near(ct[layer][key].numpy(), np.asarray(cj["0"][key][layer]),
                  f"prefill cache {key}")
    # and the window cut: without it (a model built without one: a block
    # keeps the cfg it was built with) the logits move
    full = dataclasses.replace(_port(cfg), sliding_window=0)
    lf, _ = tmodel.forward_prefill(full, load_params(
        full, params_from_numpy(full, jax.tree.map(np.asarray, params)),
        device="cpu"), torch.from_numpy(tokens), device="cpu")
    assert float((lf - lt).abs().max()) > 100 * BOUND


def test_staggered_decode_matches_reference():
    # TestPerSlotPositions' stagger (slot 1 two steps behind) and a third
    # slot seven behind, beyond the window of 4: from step 4 on its window
    # (measured from slot 0's position) holds none of its rows
    cfg = _windowed()
    pcfg = _port(cfg)
    params, model = _carried(cfg)
    b, max_len = 3, 16
    cj = init_caches(cfg, b, max_len)
    ct = tmodel.init_caches(pcfg, b, max_len, device="cpu")
    assert ct[0]["k"].dtype == torch.float8_e4m3fn
    decode = jax.jit(lambda p, c, t, pos: forward_decode(cfg, p, c, t, pos))
    rng = np.random.default_rng(2)
    offsets = np.array([0, -2, -7])
    empty = 0
    for t in range(16):
        pos = np.maximum(t + offsets, 0).astype(np.int32)
        empty += int((pos.max() + 1 - WINDOW >= pos + 1).any())
        tok = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
        lj, cj = decode(params, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = tmodel.forward_decode(pcfg, model, ct, torch.from_numpy(tok),
                                       torch.from_numpy(pos), device="cpu")
        _near(lt.numpy(), np.asarray(lj), f"step {t} logits")
        for layer in range(cfg.num_layers):
            for key in ("k", "v"):
                np.testing.assert_array_equal(
                    _bytes(ct[layer][key]), _bytes(cj["0"][key][layer]),
                    err_msg=f"step {t} layer {layer} {key}")
    assert empty > 0


def test_engine_tokens_equal_reference():
    cfg = _windowed()
    params, model = _carried(cfg)
    weights = {"gold": 2.0, "free": 1.0}
    ref = RefEngine(cfg, params=params, max_slots=3, max_len=16,
                    tenant_weights=weights)
    port = ServingEngine(_port(cfg), params=model, max_slots=3, max_len=16,
                         tenant_weights=weights, device="cpu")
    assert port.caches[0]["k"].dtype == torch.float8_e4m3fn
    for eng in (ref, port):
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit("gold" if i % 3 else "free",
                       [int(t) for t in rng.integers(
                           0, cfg.vocab_size, int(rng.integers(5, 10)))],
                       max_new_tokens=int(rng.integers(3, 7)))
    ref_done, port_done = ref.run(max_steps=30), port.run(max_steps=30)
    assert len(port_done) == len(ref_done) == 6
    for a, b_ in zip(port_done, ref_done):
        assert (a.rid, a.slot, a.out_tokens) == (b_.rid, b_.slot,
                                                 b_.out_tokens)
    np.testing.assert_array_equal(port.pos.numpy(), np.asarray(ref.pos))
    for layer, pool in enumerate(port.caches):
        for key in ("k", "v"):
            np.testing.assert_array_equal(
                _bytes(pool[key]), _bytes(ref.caches["0"][key][layer]))


# -- training with a window ----------------------------------------------------------

@pytest.mark.parametrize("block", [8, 1024])
def test_train_with_window_matches_reference(block):
    # attn_flash_block 8 divides S 32: _FlashTrain (the kernel's forward
    # with the window, the backward's windowed mask); 1,024: _attend
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              sliding_window=12, attn_flash_block=block)
    check_train(cfg, make_batch(cfg, seed=5))


def test_flash_train_window_grads_match_custom_vjp():
    # TestFlashVJP's (hq, hkv, window) = (4, 4, 48) at b 2, S 128, D 16,
    # block 32
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((2, 128, 4, 16)).astype(np.float32)
                   for _ in range(4))
    out, vjp = jax.vjp(_make_flash_train(32, 48), q, k, v)
    grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    t_out = tattention._FlashTrain.apply(tq, tk, tv, 32, 48)
    t_out.backward(torch.from_numpy(do))
    close(t_out, out, 1e-5, "out")
    for name, got, want in zip(("dq", "dk", "dv"),
                               (tq.grad, tk.grad, tv.grad), grads):
        close(got, want, 1e-5, name)


# -- the sharded decode -----------------------------------------------------------------

RANK_BODY = """
import dataclasses
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_debug_mesh_torch
from repro_torch.models.common import to_cache_dtype_torch
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import load_params
from repro_torch.models.model import forward_decode, init_caches

mesh = make_debug_mesh_torch(2, 2)
d = torch.load("inputs.pt", weights_only=False)
cfg = dataclasses.replace(ModelConfig(**d["cfg"]), dp_axes=("data",),
                          tp_axis="model")
model = load_params(cfg, d["state"], device="cpu")
S.distribute_state_torch(cfg, mesh, model)
b = d["pos"].shape[0]


def caches(kv_spec=None):
    full = init_caches(cfg, b, d["max_len"], device="cpu")
    for c, p in zip(full, d["prefill"]):
        for key, t in p.items():
            c[key][:, :t.shape[1]] = to_cache_dtype_torch(t, c[key].dtype)
    cspec = S.sanitize_specs_np(S.cache_specs_np(cfg, mesh, b), full, mesh)
    return [{k: S.distribute_tensor_torch(
        t, kv_spec if kv_spec else cs[k], mesh)
        for k, t in c.items()} for c, cs in zip(full, cspec)]


token = torch.from_numpy(d["next"])
pos = torch.from_numpy(d["pos"])
out = {}
with implicit_replication():
    for name, spec in (("seq", S.Spec(("data",), "model", None, None)),
                       ("rows", S.Spec(("data",), None, None, None)),
                       ("mesh", None)):
        cs = caches(spec)
        logits, cs = forward_decode(cfg, model, cs, token, pos, device="cpu")
        out[name] = logits.full_tensor()
        # gloo gathers no float8: gather the bytes
        k = cs[0]["k"]
        out[name + "_k"] = DTensor.from_local(
            k.to_local().view(torch.uint8), mesh, k.placements,
            run_check=False).full_tensor()
if RANK == 0:
    torch.save(out, "outputs.pt")
"""


def test_sharded_decode_with_window_and_fp8_cache(tmp_path):
    # 4 slots at staggered positions after a 16-token prefill (slot 2's
    # window holds none of its rows), a 20-row e4m3 cache sharded on the
    # sequence (two chunks of 10, and the launcher's own spec at batch 4:
    # four chunks of 5; split-KV, the first rows translated into each
    # chunk) and on the batch only, on a (2, 2) mesh of gloo ranks
    cfg = _windowed()
    params, _ = _carried(cfg, seed=3)
    rng = np.random.default_rng(4)
    s, max_len = 16, 20
    tokens = rng.integers(0, cfg.vocab_size, (4, s)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)
    pos = np.array([16, 14, 9, 15], np.int32)
    _, pre = jax.jit(lambda p, t: forward_prefill(cfg, p, t))(
        params, jnp.asarray(tokens))
    pool = {slot: {k: jnp.pad(v, [(0, 0), (0, 0), (0, max_len - s), (0, 0),
                                  (0, 0)]).astype(JDT[CACHE])
                   for k, v in c.items()} for slot, c in pre.items()}
    want, want_pool = jax.jit(lambda p, c, t, q: forward_decode(
        cfg, p, c, t, q))(params, pool, jnp.asarray(nxt), jnp.asarray(pos))
    pcfg = _port(cfg)
    torch.save({"cfg": dataclasses.asdict(pcfg),
                "state": params_from_numpy(pcfg, jax.tree.map(np.asarray,
                                                              params)),
                "prefill": [{k: torch.from_numpy(np.array(
                    pre["0"][k][layer])) for k in ("k", "v")}
                    for layer in range(cfg.num_layers)],
                "next": nxt, "pos": pos, "max_len": max_len},
               tmp_path / "inputs.pt")
    run_gloo_ranks(tmp_path, RANK_BODY, world=4, timeout=240)
    got = torch.load(tmp_path / "outputs.pt", weights_only=False)
    for name in ("seq", "rows", "mesh"):
        _near(got[name].numpy(), np.asarray(want), f"decode, cache {name}")
        np.testing.assert_array_equal(got[name + "_k"].numpy(),
                                      _bytes(want_pool["0"]["k"][0]))
