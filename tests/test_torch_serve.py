"""The port's ``ServingEngine`` (``repro_torch/serve``) against the
reference's (``repro/serve``) on the qwen3_1_7b and mamba2_1_3b smoke
configs with the same parameters, submissions and ``max_steps``, on the
CPU: every request's emitted tokens and the completion order must be
equal. For mamba2 after a 1- or 2-token prompt (shorter than the conv
tail) the two engines differ by design (R4): the port's next logits equal
the reference model's prefill over the longer prompt, the reference
engine's do not.

Equal argmaxes mean something only where the top two logits are further
apart than the two packages' logits can differ: tests/test_torch_model.py
holds those to 1e-4, so every emitted token here must lead the runner-up by
more than 2e-4 (each side may move by the bound)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import forward_decode as ref_forward_decode
from repro.models import forward_prefill as ref_forward_prefill
from repro.models import init_params
from repro.serve import ServingEngine as RefEngine
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import load_params, params_from_numpy
from repro_torch.serve import ServingEngine
from repro_torch.serve import engine as engine_mod

LOGIT_BOUND = 1e-4
WEIGHTS = {"gold": 2.0, "free": 1.0}


def _submit(eng, vocab, n=9, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        tenant = "gold" if i % 3 else "free"
        prompt = rng.integers(0, vocab, int(rng.integers(3, 10)))
        eng.submit(tenant, [int(t) for t in prompt],
                   max_new_tokens=int(rng.integers(3, 7)))


@pytest.fixture(scope="module")
def engines():
    cfg = get_smoke_config("qwen3_1_7b")
    pcfg = PortConfig(**dataclasses.asdict(cfg))
    params = init_params(cfg, jax.random.PRNGKey(0))
    model = load_params(pcfg, params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params)), device="cpu")
    # max_len 12: long prompts with many new tokens run past the cache
    ref = RefEngine(cfg, params=params, max_slots=3, max_len=12,
                    tenant_weights=WEIGHTS)
    port = ServingEngine(pcfg, params=model, max_slots=3, max_len=12,
                         tenant_weights=WEIGHTS, device="cpu")
    _submit(ref, cfg.vocab_size)
    _submit(port, cfg.vocab_size)

    gaps = []                            # top-2 gap at each emitted token

    def top2_gap(rows):
        top = torch.topk(rows, 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())

    def prefill(*a, **k):
        logits, caches = engine_mod_forward_prefill(*a, **k)
        top2_gap(logits)
        return logits, caches

    def decode(*a, **k):
        logits, caches = engine_mod_forward_decode(*a, **k)
        top2_gap(logits[[r.slot for r in port.active.values()]])
        return logits, caches

    engine_mod_forward_prefill = engine_mod.forward_prefill
    engine_mod_forward_decode = engine_mod.forward_decode
    mp = pytest.MonkeyPatch()
    mp.setattr(engine_mod, "forward_prefill", prefill)
    mp.setattr(engine_mod, "forward_decode", decode)
    try:
        ref_done = ref.run(max_steps=40)
        port_done = port.run(max_steps=40)
    finally:
        mp.undo()
    return ref, port, ref_done, port_done, gaps


def test_same_tokens_and_completion_order(engines):
    ref, port, ref_done, port_done, _ = engines
    assert len(port_done) == len(ref_done) == 9
    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    for a, b in zip(port_done, ref_done):
        assert (a.tenant, a.slot, a.out_tokens) == (b.tenant, b.slot,
                                                    b.out_tokens)
        assert a.done and len(a.out_tokens) == a.max_new_tokens
    assert port._steps == ref._steps
    np.testing.assert_array_equal(port.pos.numpy(), np.asarray(ref.pos))
    # some request decoded at a position past the cache (pos >= max_len)
    assert any(len(r.prompt) + len(r.out_tokens) - 2 >= port.max_len
               for r in port_done)


def test_emitted_tokens_are_decided(engines):
    *_, port_done, gaps = engines
    assert len(gaps) == sum(len(r.out_tokens) for r in port_done)
    assert min(gaps) > 2 * LOGIT_BOUND


def test_stats_count_the_run(engines):
    _, port, _, port_done, _ = engines
    st = port.stats
    assert st["prefills"] == len(port_done)
    assert st["prefill_tokens"] == sum(len(r.prompt) for r in port_done)
    assert st["decode_steps"] == port._steps
    assert st["decode_tokens"] == sum(len(r.out_tokens) - 1
                                      for r in port_done)


def test_admission_is_weighted_deficit_order():
    cfg = PortConfig(**dataclasses.asdict(get_smoke_config("qwen3_1_7b")))
    eng = ServingEngine(cfg, max_slots=4, max_len=16, tenant_weights=WEIGHTS,
                        device="cpu")
    for tenant in ("free", "gold", "free", "gold", "bronze"):
        eng.submit(tenant, [1, 2, 3], max_new_tokens=8)
    # all idle: stable order of first submission
    assert eng._admit_order() == ["free", "gold", "bronze"]
    eng.step()                           # one admission per tenant
    assert sorted(r.tenant for r in eng.active.values()) == [
        "bronze", "free", "gold"]
    assert eng.free_slots == [0]         # slots popped from the end
    # gold holds 1 slot at weight 2 (0.5) and goes before free (1.0)
    assert eng._admit_order() == ["gold", "free"]
    with pytest.raises(ValueError, match="holds"):
        eng.submit("free", list(range(17)))


def _mamba_engines():
    cfg = get_smoke_config("mamba2_1_3b")
    pcfg = PortConfig(**dataclasses.asdict(cfg))
    params = init_params(cfg, jax.random.PRNGKey(0))
    # nonzero A_log, D and dt_bias, so the decay, skip and dt bias all act
    rng = np.random.default_rng(1)
    mamba = params["groups"]["0"]["mamba"]
    for name, lo, hi in (("A_log", -1.0, 1.0), ("D", 0.5, 1.5),
                         ("dt_bias", -1.0, 1.0)):
        mamba[name] = jax.numpy.asarray(
            rng.uniform(lo, hi, mamba[name].shape), jax.numpy.float32)
    model = load_params(pcfg, params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params)), device="cpu")
    ref = RefEngine(cfg, params=params, max_slots=3, max_len=24,
                    tenant_weights=WEIGHTS)
    port = ServingEngine(pcfg, params=model, max_slots=3, max_len=24,
                         tenant_weights=WEIGHTS, device="cpu")
    return cfg, params, ref, port


@pytest.fixture(scope="module")
def mamba_engines():
    cfg, _, ref, port = _mamba_engines()
    _submit(ref, cfg.vocab_size)      # prompts of 3..9 tokens
    _submit(port, cfg.vocab_size)
    gaps = []

    def prefill(*a, **k):
        logits, caches = forward_prefill(*a, **k)
        top = torch.topk(logits, 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())
        return logits, caches

    def decode(*a, **k):
        logits, caches = forward_decode(*a, **k)
        rows = logits[[r.slot for r in port.active.values()]]
        top = torch.topk(rows, 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())
        return logits, caches

    forward_prefill = engine_mod.forward_prefill
    forward_decode = engine_mod.forward_decode
    mp = pytest.MonkeyPatch()
    mp.setattr(engine_mod, "forward_prefill", prefill)
    mp.setattr(engine_mod, "forward_decode", decode)
    try:
        ref_done = ref.run(max_steps=40)
        port_done = port.run(max_steps=40)
    finally:
        mp.undo()
    return ref, port, ref_done, port_done, gaps


def test_mamba_same_tokens_and_completion_order(mamba_engines):
    ref, port, ref_done, port_done, gaps = mamba_engines
    assert len(port_done) == len(ref_done) == 9
    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    for a, b in zip(port_done, ref_done):
        assert len(a.prompt) >= 3
        assert (a.tenant, a.slot, a.out_tokens) == (b.tenant, b.slot,
                                                    b.out_tokens)
        assert a.done and len(a.out_tokens) == a.max_new_tokens
    assert port._steps == ref._steps
    # every emitted token is decided: its lead over the runner-up is wider
    # than the two packages' logits can differ (tests/test_torch_ssm.py)
    assert len(gaps) == sum(len(r.out_tokens) for r in port_done)
    assert min(gaps) > 2 * LOGIT_BOUND


@pytest.mark.parametrize("n", [1, 2])
def test_mamba_short_prompt_conv_tail_is_right_aligned(n):
    cfg, params, ref, port = _mamba_engines()
    prompt = [int(t) for t in np.random.default_rng(n).integers(
        0, cfg.vocab_size, n)]
    got = []

    def decode(*a, **k):
        logits, caches = forward_decode(*a, **k)
        got.append(logits)
        return logits, caches

    forward_decode = engine_mod.forward_decode
    port.submit("gold", prompt, max_new_tokens=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "forward_decode", decode)
        port.step()                      # prefill, then one decode step
    (req,) = port.active.values()
    longer = prompt + [req.out_tokens[0]]
    want, _ = ref_forward_prefill(cfg, params,
                                  jax.numpy.asarray([longer], jax.numpy.int32))
    np.testing.assert_allclose(got[0][req.slot].numpy(), np.asarray(want[0]),
                               atol=LOGIT_BOUND, rtol=0)
    # the reference engine, which pads the tail at the end, differs there
    ref.submit("gold", prompt, max_new_tokens=4)
    ref._prefill_into_slot(ref.queues["gold"].popleft())
    (rreq,) = ref.active.values()
    assert rreq.out_tokens == req.out_tokens[:1]
    tokens = np.zeros(ref.max_slots, np.int32)
    tokens[rreq.slot] = rreq.out_tokens[0]
    ref_logits, _ = ref_forward_decode(cfg, params, ref.caches,
                                       jax.numpy.asarray(tokens), ref.pos)
    assert np.abs(np.asarray(ref_logits[rreq.slot])
                  - np.asarray(want[0])).max() > 1e-2
