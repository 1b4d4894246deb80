"""The port's train step (``repro_torch.train.step``) against the JAX
reference's (``repro.train.step.build_train_step``, jitted) on the same
params (carried across with ``convert.params_from_numpy``) and batches
drawn from a numpy seed, in float32 on the CPU: two steps with one and
with two microbatches, for qwen3_1_7b and for qwen2_vl_72b (M-RoPE
positions (3, B, S): batch second; the vision stub's embeddings), after
each step the metrics, every param and both moments.

Bounds (float32, summation order only): metrics 1e-4 x |reference|;
params and moments 1e-4 x max|reference| a tensor, as the gradients of
``tests/test_torch_train_model.py``. After step 1 the moments are (1 - b)
g and (1 - b) g^2, so they inherit the gradients' bound; the params take the
update with eps 1e-3 (``OC``), where it is Lipschitz in the gradients.
The optimizer alone is held at the default eps on equal gradients in
``tests/test_torch_train_model.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import init_params
from repro.train.optimizer import OptimizerConfig
from repro.train.step import build_train_step, make_train_state
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import load_params, params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.step import (build_train_step_torch,
                                    make_train_state_torch, split_batch_torch)

BOUND = 1e-4
BATCH, SEQ = 4, 32
#: eps 1e-3: at eps 1e-8 Adam's first update is g / |g|, which a float32
#: summation-order difference flips wherever a gradient entry cancels to
#: ~1e-9 (seen: 7.8e-5 on a param whose bound is 2.5e-5); at 1e-3 the
#: update is Lipschitz in g (slope <= 1 / eps), so the gradients' 1e-4
#: bound carries over to the params (1e-4 left a zero-initialized norm
#: scale at 1.02 x its bound after step 1)
OC = OptimizerConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10, eps=1e-3)


def _port(cfg):
    return PortConfig(**dataclasses.asdict(cfg))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.rope_type == "mrope":
        # distinct t, h, w ids a row, so a wrong split shows
        pos = np.stack([np.arange(SEQ) + 3 * c + r for c in range(3)
                        for r in range(BATCH)]).reshape(3, BATCH, SEQ)
        batch["positions"] = pos.astype(np.int32)
    if cfg.frontend != "none":
        batch["extra_embeds"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
        batch["extra_mask"] = np.ascontiguousarray(np.broadcast_to(
            (np.arange(SEQ) < 8)[None], (BATCH, SEQ)))
    return batch


def close(got, want, what):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    bound = BOUND * max(float(np.abs(want).max()), 1e-30)
    assert err <= bound, f"{what}: max err {err:.3e} > bound {bound:.3e}"


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "qwen2_vl_72b"])
def test_train_step_matches_reference(arch, microbatches):
    cfg = get_smoke_config(arch)
    pcfg = _port(cfg)
    params = init_params(cfg, jax.random.PRNGKey(0))
    state = make_train_state(cfg, params, OC)
    step = jax.jit(build_train_step(cfg, OC, microbatches))
    model = load_params(pcfg, params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params)), device="cpu")
    t_state = make_train_state_torch(
        pcfg, model, topt.OptimizerConfig(**dataclasses.asdict(OC)),
        device="cpu")
    t_step = build_train_step_torch(
        pcfg, topt.OptimizerConfig(**dataclasses.asdict(OC)), microbatches,
        device="cpu")
    for i in range(2):
        batch = _batch(cfg, seed=10 + i)
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        t_state, t_metrics = t_step(t_state, batch)
        assert set(metrics) <= set(t_metrics)
        assert set(t_metrics) == {"loss", "nll", "aux_loss", "lr",
                                  "grad_norm"}
        for key, want in metrics.items():
            got = float(t_metrics[key])
            assert abs(got - float(want)) <= BOUND * abs(float(want)), \
                (i, key, got, float(want))
        assert int(t_state["opt"]["step"]) == int(state["opt"]["step"]) \
            == i + 1
        want = {"param": params_from_numpy(pcfg, jax.tree.map(
                    np.asarray, state["params"])),
                "mu": params_from_numpy(pcfg, jax.tree.map(
                    np.asarray, state["opt"]["mu"])),
                "nu": params_from_numpy(pcfg, jax.tree.map(
                    np.asarray, state["opt"]["nu"]))}
        got = {"param": dict(t_state["params"].named_parameters()),
               "mu": t_state["opt"]["mu"], "nu": t_state["opt"]["nu"]}
        for kind in want:
            assert set(got[kind]) == set(want[kind])
            for name, w in want[kind].items():
                close(got[kind][name], w.numpy(), f"step {i + 1} {kind} "
                                                  f"{name}")


def test_split_batch_takes_mrope_positions_on_their_second_dim():
    cfg = get_smoke_config("qwen2_vl_72b")
    batch = _batch(cfg, seed=1)
    pieces = split_batch_torch(batch, 2)
    assert [p["tokens"].shape for p in pieces] == [(2, SEQ)] * 2
    assert [p["positions"].shape for p in pieces] == [(3, 2, SEQ)] * 2
    np.testing.assert_array_equal(pieces[1]["positions"],
                                  batch["positions"][:, 2:])
    np.testing.assert_array_equal(pieces[1]["extra_embeds"],
                                  batch["extra_embeds"][2:])
    with pytest.raises(ValueError, match="microbatches"):
        split_batch_torch(batch, 3)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_train_entry_points_default_to_cuda(no_cuda):
    from repro_torch.configs import get_smoke_config as port_smoke
    from repro_torch.models import model as tmodel
    from repro_torch.models.convert import opt_state_from_numpy
    cfg = port_smoke("qwen3_1_7b")
    params = tmodel.init_params(cfg, device="cpu")
    oc = topt.OptimizerConfig()
    batch = _batch(get_smoke_config("qwen3_1_7b"), seed=2)
    state = make_train_state_torch(cfg, params, oc, device="cpu")
    zeros = {"mu": {"embed": np.zeros((1,))}, "nu": {}, "step": 0}
    calls = [
        lambda: tmodel.forward_train_torch(cfg, params, batch),
        lambda: make_train_state_torch(cfg, params, oc),
        lambda: build_train_step_torch(cfg, oc)(state, batch),
        lambda: build_train_step_torch(cfg, oc, 2)(state, batch),
        lambda: opt_state_from_numpy(cfg, zeros),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    _, metrics = build_train_step_torch(cfg, oc, device="cpu")(state, batch)
    assert np.isfinite(float(metrics["loss"]))
