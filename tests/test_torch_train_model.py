"""The port's training forward and gradients (``repro_torch.models``'s
``forward_train_torch``, ``_FlashTrain``, ``ssd_chunked_train``) and its
optimizer (``repro_torch.train.optimizer``) against the JAX reference's
(``forward_train`` under ``jax.value_and_grad``, ``_make_flash_train``,
``repro.train.optimizer``), on the reference's params carried across with
``convert.params_from_numpy`` and inputs drawn from a numpy seed, in
float32 on the CPU (the kernels' plain versions).

Bounds: loss, metrics and every gradient 1e-4 x max|reference| (float32,
summation order only); ``_FlashTrain``'s dq, dk, dv 1e-5 x max|.| and the
plain lse 1e-6; the optimizer 1e-6 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_smoke_config
from repro.models import forward_train, init_params
from repro.models.attention import _flash_fwd_scan, _make_flash_train
from repro.train import optimizer as ref_opt
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import (load_params, opt_state_from_numpy,
                                        params_from_numpy)
from repro_torch.train import optimizer as topt

BOUND = 1e-4
BATCH, SEQ = 2, 32


def _port(cfg):
    return PortConfig(**dataclasses.asdict(cfg))


def make_batch(cfg, seed=1):
    """tokens, labels (tokens shifted by one), M-RoPE positions and, for a
    frontend stub, embeddings on the first 8 positions, as
    ``tests/test_arch_smoke.py`` builds them, drawn with numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.rope_type == "mrope":
        pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32)[None],
                              (BATCH, SEQ))
        batch["positions"] = np.ascontiguousarray(
            np.broadcast_to(pos[None], (3, BATCH, SEQ)))
    if cfg.frontend != "none":
        batch["extra_embeds"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
        batch["extra_mask"] = np.ascontiguousarray(np.broadcast_to(
            (np.arange(SEQ) < 8)[None], (BATCH, SEQ)))
    return batch


def close(got, want, rel, what):
    """max |got - want| <= rel x max|want| (a tensor of zeros: <= rel)."""
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    bound = rel * max(float(np.abs(want).max()) if want.size else 0.0,
                      1.0 if not np.abs(want).max() else 0.0)
    assert err <= bound, f"{what}: max err {err:.3e} > bound {bound:.3e}"


def train_reference(cfg, batch, seed=0):
    """(params tree, loss, metrics, grads tree) of the jitted reference."""
    params = init_params(cfg, jax.random.PRNGKey(seed))
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: forward_train(cfg, p, b), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    return (jax.tree.map(np.asarray, params), float(loss),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def train_port(cfg, tree, batch):
    """(loss, metrics, grads by param name) of the port on the carried
    params."""
    pcfg = _port(cfg)
    model = load_params(pcfg, params_from_numpy(pcfg, tree), device="cpu")
    model.requires_grad_(True)
    loss, metrics = tmodel.forward_train_torch(pcfg, model, batch,
                                               device="cpu")
    loss.backward()
    return loss, metrics, {n: p.grad for n, p in model.named_parameters()}


def check_train(cfg, batch):
    tree, loss, metrics, grads = train_reference(cfg, batch)
    t_loss, t_metrics, t_grads = train_port(cfg, tree, batch)
    close(t_loss, loss, BOUND, "loss")
    assert set(t_metrics) == set(metrics) == {"loss", "nll", "aux_loss"}
    for key, want in metrics.items():
        close(t_metrics[key], want, BOUND, key)
    want_grads = params_from_numpy(_port(cfg), grads)
    assert set(t_grads) == set(want_grads)
    for name, want in want_grads.items():
        assert t_grads[name] is not None, name
        assert t_grads[name].dtype == want.dtype, name
        close(t_grads[name], want.numpy(), BOUND, f"grad {name}")
    return metrics


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_and_grads_match_reference(arch):
    cfg = get_smoke_config(arch)
    metrics = check_train(cfg, make_batch(cfg))
    assert np.isfinite(metrics["loss"])
    if cfg.has_moe():
        assert metrics["aux_loss"] > 0


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "granite_moe_3b_a800m",
                                  "jamba_v0_1_52b", "qwen2_vl_72b",
                                  "gemma_2b"])
def test_flash_train_path_matches_reference(arch, monkeypatch):
    # attn_flash_block 8 divides S 32 and is below it: the reference takes
    # _make_flash_train, the port _FlashTrain
    cfg = dataclasses.replace(get_smoke_config(arch), attn_flash_block=8)
    calls = []
    apply = tattention._FlashTrain.apply

    def counted(*args):
        calls.append(args[3])
        return apply(*args)
    monkeypatch.setattr(tattention._FlashTrain, "apply", counted)
    check_train(cfg, make_batch(cfg, seed=3))
    n_attn = sum(m == "attn" for m, _ in cfg.block_pattern) * cfg.groups
    # remat="full": each attention layer's forward runs again in the
    # backward
    assert calls == [8] * (2 * n_attn)


def test_attend_route_without_flash_block(monkeypatch):
    cfg = _port(get_smoke_config("qwen3_1_7b"))
    monkeypatch.setattr(tattention._FlashTrain, "apply", None)
    q = torch.zeros(1, 8, cfg.num_heads, cfg.head_dim)
    k = torch.zeros(1, 8, cfg.num_kv_heads, cfg.head_dim)
    # S 8 does not exceed the block (1,024): _attend, not _FlashTrain
    assert tattention._attend_any_torch(cfg, q, k, k).shape == q.shape


def _flash_inputs(seed=0, b=2, s=32, hq=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, hq, d))]


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1), (2, 2)])
def test_flash_train_grads_match_custom_vjp(hq, hkv):
    q, k, v, do = _flash_inputs(hq=hq, hkv=hkv)
    f = _make_flash_train(8, 0)
    out, vjp = jax.vjp(f, q, k, v)
    dq, dk, dv = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    t_out = tattention._FlashTrain.apply(tq, tk, tv, 8)
    t_out.backward(torch.tensor(do))
    close(t_out, out, 1e-5, "out")
    for name, got, want in (("dq", tq.grad, dq), ("dk", tk.grad, dk),
                            ("dv", tv.grad, dv)):
        assert got.dtype == torch.float32
        close(got, want, 1e-5, name)


def test_plain_lse_matches_flash_fwd_scan():
    q, k, v, _ = _flash_inputs(seed=1)
    out, lse = _flash_fwd_scan(8, 0, q, k, v)
    b, s, hq, d = q.shape
    t_out, t_lse = flash_ref.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), return_lse=True)
    assert t_lse.shape == (b, hq, s) and t_lse.dtype == torch.float32
    # the reference's (B, Hkv, rep, S) is head hk * rep + r
    close(t_lse, np.asarray(lse).reshape(b, hq, s), 1e-6, "lse")
    close(t_out, out, 1e-5, "out")
    # the wrapper takes the plain version for CPU tensors, lse included
    from repro_torch.kernels.flash_attention import kernel
    before = kernel.flash_attention.launches, \
        kernel.flash_attention.lse_launches
    w_out, w_lse = kernel.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), return_lse=True)
    assert torch.equal(w_lse, t_lse) and torch.equal(w_out, t_out)
    assert (kernel.flash_attention.launches,
            kernel.flash_attention.lse_launches) == before


def test_ssd_train_grads_equal_plain_autograd():
    # _SsdTrain (kernel forward, plain version's backward) against autograd
    # straight through the plain version, model layout (B, S, H, P)
    rng = np.random.default_rng(4)
    b, s, h, p, n, chunk = 2, 40, 3, 8, 5, 16
    arrays = [rng.standard_normal((b, s, h, p)),
              np.log1p(np.exp(rng.standard_normal((b, s, h)))) / 2,
              -np.exp(0.3 * rng.standard_normal(h)),
              rng.standard_normal((b, s, n)) / 2,
              rng.standard_normal((b, s, n)) / 2]
    dy = torch.tensor(rng.standard_normal((b, s, h, p)), dtype=torch.float32)

    def leaves():
        return [torch.tensor(a, dtype=torch.float32, requires_grad=True)
                for a in arrays]
    ins = leaves()
    y = ssd_ops.ssd_chunked_train(*ins, chunk=chunk)
    y.backward(dy)
    want_ins = leaves()
    x, dt, a, bm, cm = want_ins
    y_want, _ = ssd_ref.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), a,
                                 bm, cm, chunk=chunk)
    y_want.transpose(1, 2).backward(dy)
    assert torch.equal(y, y_want.transpose(1, 2))
    for got, want in zip(ins, want_ins):
        assert torch.allclose(got.grad, want.grad, rtol=1e-6, atol=1e-6)


def test_mixed_dtypes_name_their_roadmap_item():
    cfg = dataclasses.replace(_port(get_smoke_config("qwen3_1_7b")),
                              dtype="bfloat16", param_dtype="float32")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item "
                                                  "13"):
        tmodel.init_params(cfg, device="cpu")


def test_remat_dots_names_its_roadmap_item():
    cfg = dataclasses.replace(_port(get_smoke_config("qwen3_1_7b")),
                              remat="dots")
    model = tmodel.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item "
                                                  "13"):
        tmodel.forward_train_torch(cfg, model, make_batch(cfg),
                                   device="cpu")


@pytest.mark.parametrize("remat", ["none", "full"])
def test_remat_keeps_loss_and_grads(remat):
    # recomputing each group in the backward changes nothing
    cfg = dataclasses.replace(get_smoke_config("jamba_v0_1_52b"),
                              remat=remat)
    check_train(cfg, make_batch(cfg, seed=5))


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (2, 5))
    from repro.models.model import softmax_xent
    close(tmodel.softmax_xent_torch(torch.tensor(logits),
                                    torch.tensor(labels)),
          softmax_xent(jnp.asarray(logits), jnp.asarray(labels)), 1e-6,
          "xent")


# -- the optimizer -------------------------------------------------------------

OC = ref_opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=4, decay_steps=20,
                             min_lr_ratio=0.1)


def _oc_port(oc):
    return topt.OptimizerConfig(**dataclasses.asdict(oc))


@pytest.mark.parametrize("step", [0, 1, 3, 4, 12, 20, 35])
def test_lr_schedule_matches_reference(step):
    # 0, 1, inside the warmup, its end, mid-decay, the end and past it
    want = float(ref_opt.schedule(OC, jnp.asarray(step, jnp.int32)))
    got = topt.lr_schedule_torch(_oc_port(OC), torch.tensor(step))
    assert got.dtype == torch.float32
    close(got, want, 1e-6, f"lr at {step}")


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    mu = {k: 0.1 * rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: 0.1 * rng.random(s).astype(np.float32)
          for k, s in shapes.items()}
    return params, grads, mu, nu


def test_global_norm_matches_reference():
    _, grads, _, _ = _opt_inputs(7)
    close(topt.global_norm_torch({k: torch.tensor(v)
                                  for k, v in grads.items()}),
          ref_opt.global_norm(grads), 1e-6, "global norm")


@pytest.mark.parametrize("step0,clip", [(0, 1.0), (9, 1.0), (9, 100.0)])
def test_adamw_update_matches_reference(step0, clip):
    # step 1 from zero moments, and a step past the warmup from non-zero
    # moments (clipped, and not)
    params, grads, mu, nu = _opt_inputs(8)
    oc = dataclasses.replace(OC, clip_norm=clip)
    if step0 == 0:
        mu = {k: np.zeros_like(v) for k, v in mu.items()}
        nu = {k: np.zeros_like(v) for k, v in nu.items()}
    state = {"mu": mu, "nu": nu, "step": np.int32(step0)}
    new_p, new_s, metrics = ref_opt.adamw_update(
        params, grads, jax.tree.map(jnp.asarray, state), oc)
    t_params = {k: torch.tensor(v) for k, v in params.items()}
    t_state = {"mu": {k: torch.tensor(v) for k, v in mu.items()},
               "nu": {k: torch.tensor(v) for k, v in nu.items()},
               "step": torch.tensor(step0)}
    t_state, t_metrics = topt.adamw_update_torch(
        t_params, {k: torch.tensor(v) for k, v in grads.items()}, t_state,
        _oc_port(oc))
    assert int(t_state["step"]) == int(new_s["step"]) == step0 + 1
    for key in ("lr", "grad_norm"):
        close(t_metrics[key], metrics[key], 1e-6, key)
    for k in params:
        close(t_params[k], new_p[k], 1e-6, f"param {k}")
        close(t_state["mu"][k], new_s["mu"][k], 1e-6, f"mu {k}")
        close(t_state["nu"][k], new_s["nu"][k], 1e-6, f"nu {k}")


def test_opt_state_from_numpy_carries_the_reference_state():
    cfg = get_smoke_config("granite_moe_3b_a800m")
    params = init_params(cfg, jax.random.PRNGKey(0))
    state = ref_opt.init_opt_state(params, OC)
    state = {"mu": jax.tree.map(lambda a: np.asarray(a) + 0.5, state["mu"]),
             "nu": jax.tree.map(np.asarray, state["nu"]),
             "step": np.int32(7)}
    pcfg = _port(cfg)
    got = opt_state_from_numpy(pcfg, state, device="cpu")
    model = tmodel.init_params(pcfg, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert set(got["mu"]) == set(got["nu"]) == names
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int64
    assert all(bool((t == 0.5).all()) for t in got["mu"].values())
    assert all(t.dtype == torch.float32 for t in got["nu"].values())
