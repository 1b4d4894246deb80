"""The port's sharded execution computes what one device computes: the
reference's smoke params for qwen3_1_7b, granite_moe_3b_a800m and
jamba_v0_1_52b (the reference's small-mesh set), carried across with
``convert.params_from_numpy`` and sharded into DTensors by
``launch.sharding.distribute_state_torch`` on a (2, 2) ("data", "model")
mesh of 4 gloo CPU ranks, with ``cfg.dp_axes``/``cfg.tp_axis`` set so that
``constrain_torch``, ``unshard_dp_torch`` and the ``local_map`` regions
act. In float32:

  * the sharded ``forward_prefill``'s last-position logits equal the
    jitted reference ``forward_prefill``'s within 1e-4 x max(1, max|ref|);
  * one sharded ``build_train_step_torch`` step's loss and grad norm
    equal the jitted reference step's within 1e-4 x |ref|, and every
    updated param within 1e-4 x max|ref| a tensor (eps 1e-3, as
    ``tests/test_torch_train_step.py``);
  * the sharded decode step after the prefill equals the reference's
    ``forward_decode`` logits, with the attention caches sharded on the
    sequence (split-KV: the decode kernel's plain version on each chunk,
    merged by its log-sum-exps), on the batch only (the plain version
    on each device's whole rows) and on the head dim
    (``decode_cache_shard="headdim"``: each device's partial scores over
    its slice of D summed across the slices).

The ranks run as four subprocesses (``tests/torch_gloo.py``) with a
timeout; the reference runs here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import forward_decode, forward_prefill, init_params
from repro.train.optimizer import OptimizerConfig
from repro.train.step import build_train_step, make_train_state
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import params_from_numpy
from torch_gloo import run_gloo_ranks

ARCHS = ("qwen3_1_7b", "granite_moe_3b_a800m", "jamba_v0_1_52b")
BATCH, SEQ = 4, 128           # 512 tokens: two MoE routing groups
BOUND = 1e-4
OC = OptimizerConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10, eps=1e-3)

RANK_BODY = """
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_debug_mesh_torch
from repro_torch.models.convert import load_params
from repro_torch.models.model import (forward_decode, forward_prefill,
                                      init_caches)
from repro_torch.train import optimizer as topt
from repro_torch.train.step import (build_train_step_torch,
                                    make_train_state_torch)

mesh = make_debug_mesh_torch(2, 2)
data = torch.load("inputs.pt", weights_only=False)
rows = S.Spec(("data",), None)
out = {}
for arch, d in data.items():
    cfg = get_smoke_config(arch, dp_axes=("data",), tp_axis="model")
    model = load_params(cfg, d["state"], device="cpu")
    S.distribute_state_torch(cfg, mesh, model)
    tokens = S.distribute_tensor_torch(torch.from_numpy(d["tokens"]), rows,
                                       mesh)
    b, s = d["tokens"].shape
    with implicit_replication():
        logits, pre = forward_prefill(cfg, model, tokens, device="cpu")

        def caches(kv_spec=None):
            full = init_caches(cfg, b, s + 4, device="cpu")
            for c, p in zip(full, pre):
                for key, t in p.items():
                    t = t.full_tensor()
                    if key in ("k", "v"):
                        c[key][:, :s] = t
                    else:
                        c[key].copy_(t)
            cspec = S.sanitize_specs_np(S.cache_specs_np(cfg, mesh, b), full,
                                        mesh)
            return [{k: S.distribute_tensor_torch(
                t, kv_spec if kv_spec and k in ("k", "v") else cs[k], mesh)
                for k, t in c.items()} for c, cs in zip(full, cspec)]
        token = S.distribute_tensor_torch(
            torch.from_numpy(d["next"]),
            S.sanitize_specs_np(S.token_specs_np(mesh, b),
                                torch.from_numpy(d["next"]), mesh), mesh)
        dec, _ = forward_decode(cfg, model, caches(), token, s, device="cpu")
        # the attention caches sharded on batch only: no split-KV
        dec_rows, _ = forward_decode(
            cfg, model, caches(S.Spec(("data",), None, None, None)), token,
            s, device="cpu")
        # the attention caches sharded on the head dim over "model", as
        # cache_specs_np lays them out with decode_cache_shard="headdim"
        # at this batch: partial scores summed across the slices
        hd_opts = S.ShardingOptions(decode_cache_shard="headdim",
                                    shard_cache_seq_threshold=b)
        hd_spec = next(c["k"] for c in S.cache_specs_np(cfg, mesh, b,
                                                        hd_opts)
                       if "k" in c)
        dec_hd, _ = forward_decode(cfg, model, caches(hd_spec), token, s,
                                   device="cpu")
    res = {"logits": logits.full_tensor(), "decode": dec.full_tensor(),
           "decode_rows": dec_rows.full_tensor(),
           "decode_headdim": dec_hd.full_tensor()}

    model = load_params(cfg, d["state"], device="cpu")
    oc = topt.OptimizerConfig(**d["oc"])
    state = make_train_state_torch(cfg, model, oc, device="cpu")
    _, opt, _ = S.distribute_state_torch(cfg, mesh, model, state["opt"])
    bspec = S.sanitize_specs_np(S.batch_specs_np(cfg, mesh, "train"),
                                d["batch"], mesh)
    batch = {k: S.distribute_tensor_torch(torch.from_numpy(v), bspec[k],
                                          mesh)
             for k, v in d["batch"].items()}
    step = build_train_step_torch(cfg, oc, 1, device="cpu")
    with implicit_replication():
        _, met = step({"params": model, "opt": opt}, batch)
    res["loss"] = float(met["loss"].full_tensor())
    res["grad_norm"] = float(met["grad_norm"].full_tensor())
    res["params"] = {n: p.detach().full_tensor()
                     for n, p in model.named_parameters()}
    out[arch] = res
if RANK == 0:
    torch.save(out, "outputs.pt")
"""


def _port(cfg):
    return PortConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    inputs, refs = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = get_smoke_config(arch)
        params = init_params(cfg, jax.random.PRNGKey(i))
        rng = np.random.default_rng(20 + i)
        tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(
            np.int32)
        nxt = rng.integers(0, cfg.vocab_size, (BATCH,)).astype(np.int32)
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
        logits, caches = jax.jit(
            lambda p, t, c=cfg: forward_prefill(c, p, t))(params, tokens)
        full = {slot: {k: jnp.pad(v, [(0, 0), (0, 0), (0, 4), (0, 0),
                                      (0, 0)]) if k in ("k", "v") else v
                       for k, v in c.items()}
                for slot, c in caches.items()}
        dec, _ = jax.jit(lambda p, c, t, c_=cfg: forward_decode(
            c_, p, c, t, jnp.int32(SEQ)))(params, full, nxt)
        state, metrics = jax.jit(build_train_step(cfg, OC))(
            make_train_state(cfg, params, OC),
            {k: jnp.asarray(v) for k, v in batch.items()})
        pcfg = _port(cfg)
        inputs[arch] = {
            "state": params_from_numpy(pcfg, jax.tree.map(np.asarray,
                                                           params)),
            "tokens": tokens, "next": nxt, "batch": batch,
            "oc": dataclasses.asdict(OC)}
        refs[arch] = {
            "logits": np.asarray(logits), "decode": np.asarray(dec),
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": params_from_numpy(pcfg, jax.tree.map(
                np.asarray, state["params"]))}
    torch.save(inputs, tmp / "inputs.pt")
    run_gloo_ranks(tmp, RANK_BODY, world=4, timeout=300)
    return torch.load(tmp / "outputs.pt", weights_only=False), refs


def _close(got, want, what, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = BOUND * (scale if scale is not None
                     else max(1.0, float(np.abs(want).max())))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err:.3e} > bound {bound:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_logits_equal_reference(sharded_runs, arch):
    got, want = sharded_runs
    _close(got[arch]["logits"].numpy(), want[arch]["logits"],
           f"{arch} prefill logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_logits_equal_reference(sharded_runs, arch):
    got, want = sharded_runs
    _close(got[arch]["decode"].numpy(), want[arch]["decode"],
           f"{arch} decode logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_batch_only_cache_equals_reference(sharded_runs,
                                                          arch):
    got, want = sharded_runs
    _close(got[arch]["decode_rows"].numpy(), want[arch]["decode"],
           f"{arch} decode logits, cache sharded on batch only")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_headdim_cache_equals_reference(sharded_runs, arch):
    got, want = sharded_runs
    _close(got[arch]["decode_headdim"].numpy(), want[arch]["decode"],
           f"{arch} decode logits, cache sharded on the head dim")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equals_reference(sharded_runs, arch):
    got, want = sharded_runs
    for key in ("loss", "grad_norm"):
        assert abs(got[arch][key] - want[arch][key]) <= \
            BOUND * abs(want[arch][key]), (arch, key, got[arch][key],
                                           want[arch][key])
    assert set(got[arch]["params"]) == set(want[arch]["params"])
    for name, w in want[arch]["params"].items():
        w = w.float().numpy()
        _close(got[arch]["params"][name].float().numpy(), w,
               f"{arch} {name}", scale=max(float(np.abs(w).max()), 1e-30))
