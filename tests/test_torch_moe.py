"""The port's MoE (``repro_torch/models/moe.py``) and the three MoE configs
against the JAX reference on the CPU, in float32, on parameters made by
the reference's init and carried across with ``params_from_numpy``.

- The layer: the gather routing and the dense GShard baseline against the
  reference's ``moe_apply`` (each ``moe_impl``) on the granite, grok
  (non-gated GELU experts) and jamba smoke configs, at token counts that
  hit each group rule: (2, 64) one group of 128, an odd S (groups of 1),
  S 24 (groups of 8), (1, 512) (two groups of 256) and a decode batch (8,
  1) whose free-slot rows are one repeated token-0 row; and at a capacity
  factor low enough that experts drop entries. Bounds: the reference's
  own ``TestMoEImpls`` bounds, rtol 1e-4 / atol 1e-5 on y, 1e-6 on aux,
  with atol in units of the layer's largest output where that exceeds 1
  (``_check_layer``).
- The router: its gates to 1e-6 and its expert ids equal to the
  reference's ``_route``; float32 in a bfloat16 model.
- The models: prefill and decode logits to 1e-4 (granite, jamba with its
  attention, Mamba and MoE layers, grok).
- Granite's ``ServingEngine``: the reference engine's tokens exactly, each
  emitted token decided (its lead over the runner-up above twice the
  logits' bound) and each routing decision decided (the k-th probability's
  lead over the (k+1)-th above twice ``ROUTE_BOUND``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.models import forward_decode, forward_prefill, init_caches
from repro.models import init_params
from repro.models import moe as ref_moe
from repro.serve import ServingEngine as RefEngine
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_smoke_config as torch_get_smoke_config
from repro_torch.models import model as tmodel
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import load_params, params_from_numpy
from repro_torch.serve import ServingEngine
from repro_torch.serve import engine as engine_mod

RTOL, ATOL, AUX_TOL = 1e-4, 1e-5, 1e-6
LOGIT_BOUND = 1e-4
#: router gates of the two packages on the same input: float32 products
#: and softmax in another order (measured up to 1.9e-7 on jamba's smoke
#: widths)
ROUTE_BOUND = 1e-6
ARCHS = ("granite_moe_3b_a800m", "grok_1_314b", "jamba_v0_1_52b")
WEIGHTS = {"gold": 2.0, "free": 1.0}


def _port(cfg):
    return PortConfig(**dataclasses.asdict(cfg))


def _layer(arch, seed=0, **overrides):
    """The reference's MoE params for ``arch``'s smoke config, and the
    port's ``MoE`` holding them."""
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    params = ref_moe.init_moe(cfg, jax.random.PRNGKey(seed), jnp.float32)
    layer = moe.MoE(_port(cfg), None, torch.float32)
    layer.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in params.items()}, strict=True)
    return cfg, params, layer


def _tokens(shape, d, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape + (d,)) \
        .astype(np.float32)
    if shape == (8, 1):
        x[3:] = x[3]            # free slots: the same token-0 row, 5 times
    return x


def _check_layer(cfg, params, layer, x, impl):
    cfg = dataclasses.replace(cfg, moe_impl=impl)
    want, want_aux = ref_moe.moe_apply(cfg, params, jnp.asarray(x))
    got, aux = moe.moe_apply_torch(_port(cfg), layer, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    # atol in units of max|y|: the smoke widths' fan-in rule (std
    # 1/sqrt(E) on the expert stacks) gives outputs up to ~200 (jamba), and
    # an output that cancels to ~0 between two such terms carries their
    # float32 rounding (gates 1.9e-7 apart times 200: 1.3e-5 at y = 0.013
    # on jamba at (1, 512)), whichever package computes it
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


@pytest.mark.parametrize("shape", [(2, 64), (1, 37), (1, 24), (1, 512),
                                   (8, 1)])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_moe_matches_reference(arch, shape, impl):
    cfg, params, layer = _layer(arch)
    _check_layer(cfg, params, layer, _tokens(shape, cfg.d_model), impl)


def _drops(cfg, layer, x):
    """Entries past their expert's capacity, over all groups."""
    pcfg = _port(cfg)
    gsz, g, cap = moe.moe_group_plan_torch(pcfg, x.shape[0] * x.shape[1])
    xt = torch.from_numpy(x).reshape(g, gsz, -1)
    _, idx, _ = moe._route_torch(pcfg, layer, xt)
    counts = torch.nn.functional.one_hot(idx.reshape(g, -1),
                                         cfg.moe_experts).sum(dim=1)
    return int((counts - cap).clamp(min=0).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_moe_drops_match_reference(arch, impl):
    # capacity 0.25 x the even share: most experts overflow
    cfg, params, layer = _layer(arch, seed=3, moe_capacity_factor=0.25)
    for shape in ((2, 64), (8, 1)):
        x = _tokens(shape, cfg.d_model, seed=1)
        assert _drops(cfg, layer, x) > 0
        _check_layer(cfg, params, layer, x, impl)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_reference(arch):
    cfg, params, layer = _layer(arch, seed=2)
    xt = _tokens((4, 32), cfg.d_model, seed=2)
    gates, idx, aux = ref_moe._route(cfg, params, jnp.asarray(xt))
    g_t, i_t, a_t = moe._route_torch(_port(cfg), layer, torch.from_numpy(xt))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(idx))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(gates), rtol=0,
                               atol=ROUTE_BOUND)
    assert abs(float(a_t) - float(aux)) <= AUX_TOL
    # forced to its own choice, the router gives the same gates
    g_f, i_f, a_f = moe._route_torch(_port(cfg), layer, torch.from_numpy(xt),
                                     expert_idx=i_t)
    assert torch.equal(i_f, i_t) and torch.equal(g_f, g_t)
    assert float(a_f) == float(a_t)


def test_ties_go_to_the_lower_expert():
    # a zero input gives every expert the same probability: lax.top_k
    # keeps the lower ids first, and so does the port
    cfg, params, layer = _layer("granite_moe_3b_a800m")
    xt = np.zeros((1, 3, cfg.d_model), np.float32)
    _, idx, _ = ref_moe._route(cfg, params, jnp.asarray(xt))
    _, i_t, _ = moe._route_torch(_port(cfg), layer, torch.from_numpy(xt))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(idx))
    assert i_t[0, 0].tolist() == list(range(cfg.moe_top_k))


@pytest.mark.parametrize("t,plan", [
    (1024, (256, 4, 64)), (1000, (8, 125, 2)), (1023, (1, 1023, 1)),
    (8, (8, 1, 2)), (512, (256, 2, 64))])
def test_group_plan_at_granite_widths(t, plan):
    cfg = torch_get_config("granite_moe_3b_a800m")
    assert moe.moe_group_plan_torch(cfg, t) == plan
    # the reference's own expression
    gsz = min(ref_moe.MOE_GROUP, t)
    while t % gsz:
        gsz //= 2
    cap = max(int(cfg.moe_capacity_factor * gsz * cfg.moe_top_k
                  / cfg.moe_experts), 1)
    assert plan == (gsz, t // gsz, cap)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    assert _port(get_config(arch)) == torch_get_config(arch)
    assert _port(get_smoke_config(arch)) == torch_get_smoke_config(arch)
    cfg = torch_get_config(arch.replace("_", "-"))
    assert cfg.has_moe() and cfg.moe_impl == "gather"


def test_router_stays_float32_in_bf16_model():
    cfg = dataclasses.replace(get_smoke_config("granite_moe_3b_a800m"),
                              dtype="bfloat16", param_dtype="bfloat16")
    model = tmodel.init_params(_port(cfg), 0, device="cpu")
    blk = model.layers[0].moe
    assert blk.router.dtype == torch.float32
    assert blk.wi_gate.dtype == blk.wi_up.dtype == blk.wo.dtype \
        == torch.bfloat16
    # carried across from the reference's bfloat16 params
    tree = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    state = params_from_numpy(_port(cfg), tree)
    assert state["layers.1.moe.router"].dtype == torch.float32
    assert state["layers.1.moe.wi_gate"].dtype == torch.bfloat16
    assert state["layers.1.moe.wi_gate"].shape == (
        cfg.moe_experts, cfg.d_model, cfg.expert_d_ff)
    loaded = load_params(_port(cfg), state, device="cpu")
    assert loaded.layers[1].moe.router.dtype == torch.float32
    # a bfloat16 forward routes in float32 and returns the model's dtype
    x = torch.randn(2, 5, cfg.d_model).bfloat16()
    y, aux = moe.moe_apply_torch(_port(cfg), blk, x)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


def _carried(arch, seed=1):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, jax.random.PRNGKey(seed))
    model = load_params(_port(cfg), params_from_numpy(
        _port(cfg), jax.tree.map(np.asarray, params)), device="cpu")
    return cfg, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_then_decode_matches_reference(arch):
    cfg, params, model = _carried(arch)
    pcfg = _port(cfg)
    prompt, max_len, steps = 9, 14, 3
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, prompt)).astype(np.int32)
    lj, cj = forward_prefill(cfg, params, jnp.asarray(tokens))
    lt, ct = tmodel.forward_prefill(pcfg, model, torch.from_numpy(tokens),
                                    device="cpu")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_BOUND,
                               rtol=0)
    # both packages' pools, with the prefill's caches in them
    pool_j = init_caches(cfg, 2, max_len)
    for slot, entry in cj.items():
        if "k" in entry:
            pool_j[slot] = {key: pool_j[slot][key].at[:, :, :prompt].set(
                entry[key]) for key in ("k", "v")}
        else:
            pool_j[slot] = entry
    pool_t = tmodel.init_caches(pcfg, 2, max_len, device="cpu")
    for layer, one in enumerate(ct):
        if "k" in one:
            for key in ("k", "v"):
                pool_t[layer][key][:, :prompt] = one[key]
        else:
            pool_t[layer] = one
    pos = np.array([prompt, prompt + 2], np.int32)
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        lj, pool_j = forward_decode(cfg, params, pool_j, jnp.asarray(tok),
                                    jnp.asarray(pos))
        lt, pool_t = tmodel.forward_decode(pcfg, model, pool_t,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(pos),
                                           device="cpu")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=LOGIT_BOUND, rtol=0)
        pos = pos + 1


def _submit(eng, vocab, n=9, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        tenant = "gold" if i % 3 else "free"
        prompt = rng.integers(0, vocab, int(rng.integers(3, 10)))
        eng.submit(tenant, [int(t) for t in prompt],
                   max_new_tokens=int(rng.integers(3, 7)))


@pytest.fixture(scope="module")
def granite_engines():
    cfg, params, model = _carried("granite_moe_3b_a800m", seed=0)
    ref = RefEngine(cfg, params=params, max_slots=3, max_len=12,
                    tenant_weights=WEIGHTS)
    port = ServingEngine(_port(cfg), params=model, max_slots=3, max_len=12,
                         tenant_weights=WEIGHTS, device="cpu")
    _submit(ref, cfg.vocab_size)
    _submit(port, cfg.vocab_size)
    gaps, margins = [], []

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

    def route(cfg_, p, xt, expert_idx=None):
        # every routing decision, free slots' rows included: the k-th
        # probability's lead over the (k+1)-th
        probs = torch.softmax(xt.float() @ p.router, dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg_.moe_top_k
        margins.extend((top[..., k - 1] - top[..., k]).flatten().tolist())
        return route_port(cfg_, p, xt, expert_idx)

    forward_prefill_port = engine_mod.forward_prefill
    forward_decode_port = engine_mod.forward_decode
    route_port = moe._route_torch
    mp = pytest.MonkeyPatch()
    mp.setattr(engine_mod, "forward_prefill", prefill)
    mp.setattr(engine_mod, "forward_decode", decode)
    mp.setattr(moe, "_route_torch", route)
    try:
        ref_done = ref.run(max_steps=40)
        port_done = port.run(max_steps=40)
    finally:
        mp.undo()
    return ref, port, ref_done, port_done, gaps, margins


def test_granite_engine_same_tokens_and_completion_order(granite_engines):
    ref, port, ref_done, port_done, _, _ = granite_engines
    assert len(port_done) == len(ref_done) == 9
    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    for a, b in zip(port_done, ref_done):
        assert (a.tenant, a.slot, a.out_tokens) == (b.tenant, b.slot,
                                                    b.out_tokens)
        assert a.done and len(a.out_tokens) == a.max_new_tokens
    assert port._steps == ref._steps
    np.testing.assert_array_equal(port.pos.numpy(), np.asarray(ref.pos))


def test_granite_engine_tokens_and_routes_are_decided(granite_engines):
    *_, port_done, gaps, margins = granite_engines
    assert len(gaps) == sum(len(r.out_tokens) for r in port_done)
    assert min(gaps) > 2 * LOGIT_BOUND
    # 2 layers x (9 prefills + every decode step's 3 slots)
    assert len(margins) > 2 * sum(len(r.prompt) for r in port_done)
    assert min(margins) > 2 * ROUTE_BOUND
