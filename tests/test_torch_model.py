"""The port's model (``repro_torch/models``) against the JAX reference's
(``repro/models``) on the same parameters, carried across with
``models/convert.py::params_from_numpy``: prefill logits and caches, then
decode steps at per-row positions (one of them past the cache), in float32
on the CPU (the kernels' plain versions). Bound: 1e-4 on logits and
caches (float32, summation order only; measured ~1.5e-6 on the smoke
config)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import (forward_decode, forward_prefill, init_caches,
                          init_params)
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_smoke_config as torch_get_smoke_config
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import load_params, params_from_numpy

BOUND = 1e-4


def _smoke():
    return get_smoke_config("qwen3_1_7b")


def _wide():
    # qwen3_1_7b's attention widths (d_model 2048, 16/8 heads, head_dim 128)
    # in one layer, with d_ff and vocab cut to 512 to keep the CPU test short
    return dataclasses.replace(
        get_smoke_config("qwen3_1_7b"), name="qwen3_1_7b_attn_widths",
        num_layers=1, d_model=2048, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=512, vocab_size=512,
        rope_theta=1_000_000.0)


def _port(cfg):
    """The port's copy of a reference config."""
    return PortConfig(**dataclasses.asdict(cfg))


def _carried(cfg, seed=0):
    params = init_params(cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, tree, load_params(
        _port(cfg), params_from_numpy(_port(cfg), tree), device="cpu")


def test_port_config_equals_reference():
    assert _port(_smoke()) == torch_get_smoke_config("qwen3_1_7b")
    from repro.configs import ARCH_IDS, get_config
    assert _port(get_config("qwen3-1.7b")) == torch_get_config("qwen3-1.7b")
    # every arch resolves, to the reference's config and smoke config
    for arch in ARCH_IDS:
        assert _port(get_config(arch)) == torch_get_config(arch)
        assert _port(get_smoke_config(arch)) == torch_get_smoke_config(arch)
    with pytest.raises(KeyError):
        torch_get_config("no_such_arch")


def test_params_from_numpy_round_trips():
    cfg = _smoke()
    _, tree, model = _carried(cfg)
    state = model.state_dict()
    n_leaves = 0
    for slot, blk in tree["groups"].items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(blk)[0]:
            name = ".".join(p.key for p in path)
            for g in range(cfg.groups):
                got = state[f"layers.{g + int(slot)}.{name}"].numpy()
                np.testing.assert_array_equal(got, leaf[g])
                n_leaves += 1
    np.testing.assert_array_equal(state["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(state["final_norm.scale"].numpy(),
                                  tree["final_norm"]["scale"])
    assert len(state) == n_leaves + 2          # nothing else, nothing left
    # the (in, out) layout is kept: x @ W, no transpose
    assert state["layers.0.attn.wq"].shape == (cfg.d_model, cfg.q_dim)
    bad = params_from_numpy(cfg, tree)
    bad.pop("layers.1.mlp.wo")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_params(cfg, bad, device="cpu")


def _pad(caches, max_len):
    return jax.tree.map(lambda a: jnp.pad(
        a, ((0, 0), (0, 0), (0, max_len - a.shape[2]), (0, 0), (0, 0))),
        caches)


@pytest.mark.parametrize("make_cfg,prompt,max_len,steps", [
    (_smoke, 7, 10, 4), (_wide, 5, 7, 3)])
def test_prefill_then_decode_matches_reference(make_cfg, prompt, max_len,
                                               steps):
    cfg = make_cfg()
    params, _, model = _carried(cfg, seed=1)
    pcfg = _port(cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, prompt)).astype(np.int32)
    lj, cj = forward_prefill(cfg, params, jnp.asarray(tokens))
    lt, ct = tmodel.forward_prefill(pcfg, model, torch.from_numpy(tokens),
                                    device="cpu")
    assert lt.shape == (2, cfg.vocab_padded) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=BOUND,
                               rtol=0)
    for layer in range(cfg.num_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(ct[layer][key].numpy(),
                                       np.asarray(cj["0"][key][layer]),
                                       atol=BOUND, rtol=0)

    cj = _pad(cj, max_len)
    pool = tmodel.init_caches(pcfg, 2, max_len, device="cpu")
    for layer in range(cfg.num_layers):
        for key in ("k", "v"):
            pool[layer][key][:, :prompt] = ct[layer][key]
    # row 1 starts two positions on, so it runs past the cache
    pos = np.array([prompt, max_len - 2], np.int32)
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        lj, cj = forward_decode(cfg, params, cj, jnp.asarray(tok),
                                jnp.asarray(pos))
        lt, pool = tmodel.forward_decode(pcfg, model, pool,
                                         torch.from_numpy(tok),
                                         torch.from_numpy(pos), device="cpu")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=BOUND,
                                   rtol=0)
        for layer in range(cfg.num_layers):
            for key in ("k", "v"):
                np.testing.assert_allclose(pool[layer][key].numpy(),
                                           np.asarray(cj["0"][key][layer]),
                                           atol=BOUND, rtol=0)
        pos = pos + 1
    assert pos[1] > max_len
    # padded vocab slots are masked as in the reference
    if cfg.vocab_padded > cfg.vocab_size:
        assert float(lt[:, cfg.vocab_size:].max()) == -1e9


def test_init_caches_matches_reference_shape():
    cfg = _smoke()
    ref = init_caches(cfg, 3, 16)
    port = tmodel.init_caches(_port(cfg), 3, 16, device="cpu")
    assert len(port) == cfg.num_layers
    for key in ("k", "v"):
        assert ref["0"][key].shape[1:] == tuple(port[0][key].shape)
        assert port[0][key].dtype == torch.float32
        assert not port[0][key].any()


def test_port_init_is_seeded_and_shaped():
    cfg = _port(_smoke())
    a = tmodel.init_params(cfg, 3, device="cpu").state_dict()
    b = tmodel.init_params(cfg, 3, device="cpu").state_dict()
    ref = params_from_numpy(cfg, jax.tree.map(
        np.asarray, init_params(_smoke(), jax.random.PRNGKey(0))))
    assert set(a) == set(ref)
    for name, t in a.items():
        assert t.shape == ref[name].shape and t.dtype == ref[name].dtype
        assert torch.equal(t, b[name])
        if name.endswith("scale"):
            assert not t.any()                  # zeros, applied as 1 + s
    # truncated normal at 1/sqrt(fan_in): within 2 std
    wq = a["layers.0.attn.wq"]
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
