"""The five dense and frontend configs (qwen2_5_32b: QKV bias; granite_3_8b:
untied embeddings; gemma_2b: MQA, GeGLU, tied; qwen2_vl_72b: M-RoPE and the
vision stub; musicgen_large: the GELU MLP and the audio stub) in the port
against the JAX reference, on the CPU in float32 (the kernels' plain
versions), on parameters carried across with
``models/convert.py::params_from_numpy``.

Bounds: logits and caches 1e-4 (float32, summation order only, as
tests/test_torch_model.py); ``apply_mrope`` 1e-5 against the reference
(the two packages' cos and sin may round an ulp apart) and bit for bit
against ``apply_rope`` when t == h == w; engines the reference's tokens
exactly, each emitted token leading its runner-up by more than twice the
logit bound."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.models import forward_decode, forward_prefill, init_params
from repro.models.common import apply_mrope as ref_apply_mrope
from repro.serve import ServingEngine as RefEngine
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_smoke_config as torch_get_smoke_config
from repro_torch.models import model as tmodel
from repro_torch.models.common import apply_mrope, apply_rope
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import load_params, params_from_numpy
from repro_torch.serve import ServingEngine
from repro_torch.serve import engine as engine_mod

ARCHS = ("qwen2_5_32b", "granite_3_8b", "gemma_2b", "qwen2_vl_72b",
         "musicgen_large")
FRONTENDS = ("qwen2_vl_72b", "musicgen_large")
LOGIT_BOUND = 1e-4
MROPE_BOUND = 1e-5
WEIGHTS = {"gold": 2.0, "free": 1.0}


def _port(cfg):
    return PortConfig(**dataclasses.asdict(cfg))


def _carried(arch, seed=1):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, jax.random.PRNGKey(seed))
    model = load_params(_port(cfg), params_from_numpy(
        _port(cfg), jax.tree.map(np.asarray, params)), device="cpu")
    return cfg, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    assert _port(get_config(arch)) == torch_get_config(arch)
    assert _port(get_smoke_config(arch)) == torch_get_smoke_config(arch)
    assert torch_get_config(arch.replace("_", "-")).name == arch


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_params_load_strict(arch):
    # every leaf of the reference's pytree has its place in the port's
    # module (load_state_dict(strict=True)) and keeps its values
    cfg = get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    state = params_from_numpy(_port(cfg), tree)
    model = load_params(_port(cfg), state, device="cpu")
    got = model.state_dict()
    assert set(got) == set(state)
    for key, val in state.items():
        assert torch.equal(got[key], val), key
    assert ("unembed" in got) == (not cfg.tie_embeddings)
    assert ("layers.0.attn.bq" in got) == cfg.qkv_bias
    assert ("layers.0.mlp.wi" in got) == (cfg.mlp_type == "gelu")
    assert ("layers.0.mlp.wi_gate" in got) == (cfg.mlp_type != "gelu")


def _pools(cfg, pcfg, cj, ct, prompt, max_len):
    pool_j = jax.tree.map(lambda a: jnp.pad(
        a, ((0, 0), (0, 0), (0, max_len - a.shape[2]), (0, 0), (0, 0))), cj)
    pool_t = tmodel.init_caches(pcfg, ct[0]["k"].shape[0], max_len,
                                device="cpu")
    for layer, one in enumerate(ct):
        for key in ("k", "v"):
            pool_t[layer][key][:, :prompt] = one[key]
    return pool_j, pool_t


@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_then_decode_matches_reference(arch):
    cfg, params, model = _carried(arch)
    pcfg = _port(cfg)
    prompt, max_len, steps = 9, 13, 3
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, prompt)).astype(np.int32)
    prefill = jax.jit(lambda p, t: forward_prefill(cfg, p, t))
    decode = jax.jit(lambda p, c, t, pos: forward_decode(cfg, p, c, t, pos))
    lj, cj = prefill(params, jnp.asarray(tokens))
    lt, ct = tmodel.forward_prefill(pcfg, model, torch.from_numpy(tokens),
                                    device="cpu")
    assert lt.shape == (2, cfg.vocab_padded)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_BOUND,
                               rtol=0)
    for layer in range(cfg.num_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(ct[layer][key].numpy(),
                                       np.asarray(cj["0"][key][layer]),
                                       atol=LOGIT_BOUND, rtol=0)
    pool_j, pool_t = _pools(cfg, pcfg, cj, ct, prompt, max_len)
    # per-row positions; row 1 starts two on and runs past the cache
    pos = np.array([prompt, prompt + 2], np.int32)
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        lj, pool_j = decode(params, pool_j, jnp.asarray(tok),
                            jnp.asarray(pos))
        lt, pool_t = tmodel.forward_decode(pcfg, model, pool_t,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(pos),
                                           device="cpu")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=LOGIT_BOUND, rtol=0)
        pos = pos + 1
    for layer in range(cfg.num_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(pool_t[layer][key].numpy(),
                                       np.asarray(pool_j["0"][key][layer]),
                                       atol=LOGIT_BOUND, rtol=0)


# -- M-RoPE -------------------------------------------------------------------

def _mrope_inputs(b, s, h, d, seed, top=4096):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = rng.integers(0, top, (3, b, s)).astype(np.int32)
    return x, pos


@pytest.mark.parametrize("d,sections,theta", [
    (16, (2, 3, 3), 10_000.0),             # the vision smoke config's
    (128, (16, 24, 24), 1_000_000.0)])     # qwen2_vl_72b's
def test_apply_mrope_matches_reference(d, sections, theta):
    # distinct temporal, height and width ids
    x, pos = _mrope_inputs(2, 11, 3, d, seed=d)
    assert (pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()
    want = ref_apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                      theta, sections)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MROPE_BOUND, rtol=0)
    # the components each rotate their own section: moving the width ids
    # moves only the last section's slots (and their halves' partners)
    pos_w = pos.copy()
    pos_w[2] += 1
    moved = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos_w).long(),
                        theta, sections) != got
    first = sections[0] + sections[1]
    half = d // 2
    assert not moved[..., :first].any()
    assert not moved[..., half:half + first].any()
    assert moved[..., first:half].any()


@pytest.mark.parametrize("d,sections", [(16, (2, 3, 3)),
                                        (128, (16, 24, 24))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_mrope_text_equals_apply_rope(d, sections, dtype):
    # t == h == w: M-RoPE is RoPE, bit for bit
    x, pos = _mrope_inputs(2, 9, 4, d, seed=3)
    xt = torch.from_numpy(x).to(dtype)
    p2 = torch.from_numpy(pos[0]).long()
    got = apply_mrope(xt, p2[None].expand(3, *p2.shape), 1_000_000.0,
                      sections)
    assert torch.equal(got, apply_rope(xt, p2, 1_000_000.0))
    with pytest.raises(ValueError, match="sum"):
        apply_mrope(xt, p2[None].expand(3, *p2.shape), 1e6, (1, 2, 3))


def test_mrope_model_text_positions_equal_their_rope_twin():
    # the vision smoke model with its default (t == h == w) positions gives
    # the logits of the same model under plain RoPE
    cfg, _, model = _carried("qwen2_vl_72b")
    pcfg = _port(cfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 7)))
    got, _ = tmodel.forward_prefill(pcfg, model, tokens, device="cpu")
    rope = dataclasses.replace(pcfg, rope_type="rope")
    twin = load_params(rope, model.state_dict(), device="cpu")
    want, _ = tmodel.forward_prefill(rope, twin, tokens, device="cpu")
    assert torch.equal(got, want)
    pos = tmodel._default_positions(pcfg, tokens)
    assert pos.shape == (3, 2, 7) and torch.equal(pos[0], pos[2])


# -- the frontend stubs -------------------------------------------------------

def _stub_inputs(cfg, seed=5, b=2, s=12, n_extra=6):
    """Tokens, precomputed embeddings filling the first ``n_extra``
    positions, and positions: for M-RoPE the stub's patches on a 2 x 3
    grid (t constant, h and w the grid) and the text after them, each
    component counting on from the grid's largest id; else 0..S-1."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    mask = np.zeros((b, s), bool)
    mask[:, :n_extra] = True
    if cfg.rope_type == "mrope":
        grid = np.arange(n_extra)
        text = np.arange(s - n_extra) + 3
        t = np.concatenate([np.zeros(n_extra, int), text])
        h = np.concatenate([grid // 3, text])
        w = np.concatenate([grid % 3, text])
        pos = np.broadcast_to(np.stack([t, h, w])[:, None], (3, b, s))
    else:
        pos = np.broadcast_to(np.arange(s), (b, s))
    return tokens, extra, mask, np.ascontiguousarray(pos).astype(np.int32)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_stub_prefill_matches_reference(arch):
    cfg, params, model = _carried(arch)
    pcfg = _port(cfg)
    tokens, extra, mask, pos = _stub_inputs(cfg)
    lj, cj = forward_prefill(cfg, params, jnp.asarray(tokens),
                             jnp.asarray(pos), jnp.asarray(extra),
                             jnp.asarray(mask))
    lt, ct = tmodel.forward_prefill(
        pcfg, model, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(extra), torch.from_numpy(mask), device="cpu")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_BOUND,
                               rtol=0)
    for layer in range(cfg.num_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(ct[layer][key].numpy(),
                                       np.asarray(cj["0"][key][layer]),
                                       atol=LOGIT_BOUND, rtol=0)
    # the stub's embeddings took the masked positions: without them the
    # logits move
    plain, _ = tmodel.forward_prefill(pcfg, model, torch.from_numpy(tokens),
                                      torch.from_numpy(pos), device="cpu")
    assert float((plain - lt).abs().max()) > 100 * LOGIT_BOUND


def test_embed_ignores_extras_without_a_frontend():
    # as the reference's _embed: a config with no frontend stub keeps its
    # token embeddings whatever extras it is handed
    cfg, _, model = _carried("qwen2_5_32b")
    pcfg = _port(cfg)
    tokens, extra, mask, pos = _stub_inputs(cfg)
    got, _ = tmodel.forward_prefill(pcfg, model, torch.from_numpy(tokens),
                                    None, torch.from_numpy(extra),
                                    torch.from_numpy(mask), device="cpu")
    want, _ = tmodel.forward_prefill(pcfg, model, torch.from_numpy(tokens),
                                     device="cpu")
    assert torch.equal(got, want)


# -- engines ------------------------------------------------------------------

def _submit(eng, vocab, n=9, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        tenant = "gold" if i % 3 else "free"
        prompt = rng.integers(0, vocab, int(rng.integers(3, 10)))
        eng.submit(tenant, [int(t) for t in prompt],
                   max_new_tokens=int(rng.integers(3, 7)))


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    cfg, params, model = _carried(request.param, seed=0)
    # max_len 12: long prompts with many new tokens run past the cache
    ref = RefEngine(cfg, params=params, max_slots=3, max_len=12,
                    tenant_weights=WEIGHTS)
    port = ServingEngine(_port(cfg), params=model, max_slots=3, max_len=12,
                         tenant_weights=WEIGHTS, device="cpu")
    _submit(ref, cfg.vocab_size)
    _submit(port, cfg.vocab_size)
    gaps = []

    def top2_gap(rows):
        top = torch.topk(rows, 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())

    def prefill(*a, **k):
        logits, caches = forward_prefill_port(*a, **k)
        top2_gap(logits)
        return logits, caches

    def decode(*a, **k):
        logits, caches = forward_decode_port(*a, **k)
        top2_gap(logits[[r.slot for r in port.active.values()]])
        return logits, caches

    forward_prefill_port = engine_mod.forward_prefill
    forward_decode_port = engine_mod.forward_decode
    mp = pytest.MonkeyPatch()
    mp.setattr(engine_mod, "forward_prefill", prefill)
    mp.setattr(engine_mod, "forward_decode", decode)
    try:
        ref_done = ref.run(max_steps=40)
        port_done = port.run(max_steps=40)
    finally:
        mp.undo()
    return ref, port, ref_done, port_done, gaps


def test_engine_same_tokens_and_completion_order(engines):
    ref, port, ref_done, port_done, _ = engines
    assert len(port_done) == len(ref_done) == 9
    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    for a, b in zip(port_done, ref_done):
        assert (a.tenant, a.slot, a.out_tokens) == (b.tenant, b.slot,
                                                    b.out_tokens)
        assert a.done and len(a.out_tokens) == a.max_new_tokens
    assert port._steps == ref._steps
    np.testing.assert_array_equal(port.pos.numpy(), np.asarray(ref.pos))


def test_engine_tokens_are_decided(engines):
    *_, port_done, gaps = engines
    assert len(gaps) == sum(len(r.out_tokens) for r in port_done)
    assert min(gaps) > 2 * LOGIT_BOUND
