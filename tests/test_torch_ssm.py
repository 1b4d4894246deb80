"""The port's Mamba-2 mixer and model (``repro_torch/models/ssm.py``,
``blocks.py``, ``model.py``) against the reference's on the mamba2_1_3b
smoke config, with the reference's params carried across by
``models/convert.py::params_from_numpy``, in float32 on the CPU (the
``ssd_scan`` plain version): one layer's prefill (y, conv tail, final
state) and decode step, then ``forward_prefill`` followed by
``forward_decode``, logits and caches. Bound: 1e-4 (float32, summation
order only), as tests/test_torch_model.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import (forward_decode, forward_prefill, init_caches,
                          init_params)
from repro.models.ssm import mamba_decode as ref_mamba_decode
from repro.models.ssm import mamba_train as ref_mamba_train
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_smoke_config as torch_get_smoke_config
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import load_params, params_from_numpy

BOUND = 1e-4


def _cfg():
    return get_smoke_config("mamba2_1_3b")


def _port(cfg):
    return PortConfig(**dataclasses.asdict(cfg))


def _carried(cfg, seed=0):
    params = init_params(cfg, jax.random.PRNGKey(seed))
    # nonzero A_log, D and dt_bias, so the decay, skip and dt bias all act
    groups = params["groups"]
    rng = np.random.default_rng(seed)
    for name, lo, hi in (("A_log", -1.0, 1.0), ("D", 0.5, 1.5),
                         ("dt_bias", -1.0, 1.0)):
        leaf = groups["0"]["mamba"][name]
        groups["0"]["mamba"][name] = jnp.asarray(
            rng.uniform(lo, hi, leaf.shape), jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return params, load_params(_port(cfg), params_from_numpy(_port(cfg),
                                                              tree),
                               device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BOUND,
                               rtol=0)


def test_port_config_equals_reference():
    from repro.configs import get_config
    assert _port(_cfg()) == torch_get_smoke_config("mamba2_1_3b")
    assert _port(get_config("mamba2-1.3b")) == torch_get_config(
        "mamba2-1.3b")


@pytest.mark.parametrize("s", [40, 2])
def test_mamba_train_matches_reference(s):
    cfg = _cfg()
    params, model = _carried(cfg, seed=1)
    layer = jax.tree.map(lambda a: a[1], params["groups"]["0"]["mamba"])
    x = np.random.default_rng(2).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    y_ref, st_ref = ref_mamba_train(cfg, layer, jnp.asarray(x),
                                    return_state=True)
    y, st = tssm.mamba_train(_port(cfg), model.layers[1].mamba,
                             torch.from_numpy(x), return_state=True)
    _close(y, y_ref)
    _close(st["ssm"], st_ref["ssm"])
    k = cfg.ssm_conv
    assert st["conv"].shape == (2, k - 1, cfg.d_inner + 2 * cfg.ssm_state)
    # the reference returns min(S, k-1) rows; the port right-aligns them
    # after zeros (what the causal conv saw)
    rows = min(s, k - 1)
    _close(st["conv"][:, k - 1 - rows:], st_ref["conv"])
    assert not st["conv"][:, :k - 1 - rows].any()


def test_mamba_decode_matches_reference_in_place():
    cfg = _cfg()
    params, model = _carried(cfg, seed=3)
    layer = jax.tree.map(lambda a: a[0], params["groups"]["0"]["mamba"])
    rng = np.random.default_rng(4)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    cache = {"conv": rng.standard_normal((3, cfg.ssm_conv - 1, conv_dim))
             .astype(np.float32),
             "ssm": rng.standard_normal((3, cfg.ssm_heads, cfg.ssm_headdim,
                                         cfg.ssm_state)).astype(np.float32)}
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    y_ref, new_ref = ref_mamba_decode(cfg, layer, jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, cache))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    y, out = tssm.mamba_decode(_port(cfg), model.layers[0].mamba,
                               torch.from_numpy(x), tcache)
    assert out is tcache and {k: v.data_ptr() for k, v in out.items()} \
        == ptrs                                  # updated in place
    _close(y, y_ref)
    for key in ("conv", "ssm"):
        _close(out[key], new_ref[key])


def test_prefill_then_decode_matches_reference():
    cfg = _cfg()
    pcfg = _port(cfg)
    params, model = _carried(cfg, seed=5)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    lj, cj = forward_prefill(cfg, params, jnp.asarray(tokens))
    lt, ct = tmodel.forward_prefill(pcfg, model, torch.from_numpy(tokens),
                                    device="cpu")
    assert lt.shape == (2, cfg.vocab_padded) and lt.dtype == torch.float32
    _close(lt, lj)
    for layer in range(cfg.num_layers):
        for key in ("conv", "ssm"):
            _close(ct[layer][key], cj["0"][key][layer])
    pos = np.array([37, 37], np.int32)
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        lj, cj = forward_decode(cfg, params, cj, jnp.asarray(tok),
                                jnp.asarray(pos))
        lt, ct = tmodel.forward_decode(pcfg, model, ct, torch.from_numpy(tok),
                                       torch.from_numpy(pos), device="cpu")
        _close(lt, lj)
        for layer in range(cfg.num_layers):
            for key in ("conv", "ssm"):
                _close(ct[layer][key], cj["0"][key][layer])
        pos = pos + 1


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_continues_as_the_longer_prefill(s):
    # R4 at the model: prefill s < k-1 tokens, decode the next one; the
    # logits equal the reference's prefill over all s + 1 tokens
    cfg = _cfg()
    pcfg = _port(cfg)
    params, model = _carried(cfg, seed=7)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, s + 1)
    want, _ = forward_prefill(cfg, params,
                              jnp.asarray(tokens[None], jnp.int32))
    _, caches = tmodel.forward_prefill(pcfg, model, [list(tokens[:s])],
                                       device="cpu")
    got, _ = tmodel.forward_decode(pcfg, model, caches, [int(tokens[s])], s,
                                   device="cpu")
    _close(got, want)


def test_init_caches_match_reference():
    cfg = _cfg()
    ref = init_caches(cfg, 3, 16)
    port = tmodel.init_caches(_port(cfg), 3, 16, device="cpu")
    assert len(port) == cfg.num_layers
    for key, dtype in (("conv", torch.float32), ("ssm", torch.float32)):
        assert ref["0"][key].shape[1:] == tuple(port[0][key].shape)
        assert port[0][key].dtype == dtype and not port[0][key].any()
    bf = tmodel.init_caches(dataclasses.replace(_port(cfg), dtype="bfloat16",
                                                param_dtype="bfloat16"),
                            2, 8, device="cpu")
    assert bf[0]["conv"].dtype == torch.bfloat16
    assert bf[0]["ssm"].dtype == torch.float32
    # float32 params over bfloat16 activations: the conv tail in the
    # promoted dtype, the one the reference's decode step leaves it in
    split = tmodel.init_caches(dataclasses.replace(_port(cfg),
                                                   dtype="bfloat16"),
                               2, 8, device="cpu")
    assert split[0]["conv"].dtype == torch.float32
    assert split[0]["ssm"].dtype == torch.float32


def test_bf16_params_keep_float32_leaves():
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16",
                              param_dtype="bfloat16")
    pcfg = _port(cfg)
    tree = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    state = params_from_numpy(pcfg, tree)
    for name in ("A_log", "D", "dt_bias"):
        assert state[f"layers.0.mamba.{name}"].dtype == torch.float32
    assert state["layers.0.mamba.in_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["layers.1.mamba.in_proj"].float().numpy(),
        tree["groups"]["0"]["mamba"]["in_proj"][1].astype(np.float32))
    model = load_params(pcfg, state, device="cpu")
    assert model.layers[0].mamba.D.dtype == torch.float32
    own = tmodel.init_params(pcfg, 0, device="cpu")
    assert own.layers[1].mamba.A_log.dtype == torch.float32
    assert own.layers[1].mamba.conv_w.dtype == torch.bfloat16
    logits, caches = tmodel.forward_prefill(pcfg, model, [[1, 2, 3, 4]],
                                            device="cpu")
    assert bool(torch.isfinite(logits).all())
    assert caches[0]["ssm"].dtype == torch.float32
