"""Params and activations in different dtypes, and ``remat="dots"``, in the
port (``repro_torch.models``, ``serve``, ``train``) against the JAX
reference on the reference's params carried across with
``convert.params_from_numpy`` and inputs drawn from a numpy seed, on the
CPU (the kernels' plain versions).

The two splits: float32 params over bfloat16 activations (master weights:
q, k and v come out of the projections float32, the KV cache stays
bfloat16, the residual stream is float32 from layer 0's first addition
on) and bfloat16 params over float32 activations (every product widens
its bfloat16 weight). The reference runs them with ``scan_groups=False``:
under its default ``lax.scan`` over groups, the float32-params split
changes the carry's dtype in layer 0 and the scan refuses it (ROADMAP
P19); the port's layer loop equals the unrolled run.

Bounds: logits 2^-7 x max|logit| (measured ~1e-6: the only bfloat16
roundings are the embedding's and layer 0's norm's outputs and the cache
writes, the same in both packages); engine tokens equal except where the
reference's top two logits lie within that bound; the train step's loss,
float32 gradients, params and moments 1e-4 x max|reference|, and 2^-7 x
max|reference| where the values came through bfloat16 roundings (bfloat16
params and gradients and their moments; under float32 params the
gradients that pass through a bfloat16 activation's cotangent, which the
packages add in bfloat16 in their own orders: the embedding's and layer
0's mixer norm's); the decode kernel's plain version on a float32 q over a
bfloat16 cache 1e-5 of the reference's ``_attend``; ``remat="dots"``
equal to ``"full"`` bit for bit and to the reference at the train step's
bounds."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import (forward_decode, forward_prefill, forward_train,
                          init_caches, init_params)
from repro.models import blocks as ref_blocks
from repro.models.attention import _attend
from repro.serve import ServingEngine as RefEngine
from repro.train.optimizer import OptimizerConfig
from repro.train.step import build_train_step, make_train_state
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tmodel
from repro_torch.models.common import to_cache_dtype_torch
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import load_params, params_from_numpy
from repro_torch.serve import ServingEngine
from repro_torch.train import optimizer as topt
from repro_torch.train.step import (build_train_step_torch,
                                    make_train_state_torch)

LOGIT_REL = 2.0 ** -7
BOUND = 1e-4
ROUNDED_REL = 2.0 ** -7
#: (param_dtype, dtype)
SPLITS = [("float32", "bfloat16"), ("bfloat16", "float32")]
FAMILIES = ["qwen3_1_7b", "mamba2_1_3b", "granite_moe_3b_a800m",
            "jamba_v0_1_52b"]
OC = OptimizerConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10, eps=1e-3)


def _cfg(arch, split=None, **kw):
    if split is not None:
        kw.update(param_dtype=split[0], dtype=split[1])
    return get_smoke_config(arch, scan_groups=False, **kw)


def _port(cfg):
    return PortConfig(**dataclasses.asdict(cfg))


def _carried(cfg, seed=1):
    params = init_params(cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, tree, load_params(
        _port(cfg), params_from_numpy(_port(cfg), tree), device="cpu")


def _rel_err(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _close_leaf(got, want, what, rounded=False, rounded_rel=None):
    """1e-4 x max|want|; a leaf whose values came through bfloat16
    roundings (a bfloat16 param or gradient, the moments of a bfloat16
    gradient, the gradient of a bfloat16 activation, whose cotangents the
    packages add in bfloat16 in their own orders) 2^-7 x max|want|, two
    bfloat16 roundings of its largest value, or ``rounded_rel``."""
    bound = (rounded_rel or ROUNDED_REL) \
        if rounded or got.dtype == torch.bfloat16 else BOUND
    err = _rel_err(got, want)
    assert err <= bound, (what, err, bound)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


#: with float32 params over bfloat16 activations, the gradients that pass
#: through a bfloat16 activation's cotangent: the embedding's (the scatter
#: of the embedded activation's) and layer 0's mixer norm's (its output
#: feeds q, k and v, whose three cotangents are rounded and added in
#: bfloat16)
BF16_PATH = ("embed", "layers.0.norm_mixer.scale")


def _rounded_torch(split, name):
    """Whether a param's gradient comes through bfloat16 roundings: every
    one with bfloat16 params, ``BF16_PATH``'s with float32 params over
    bfloat16 activations."""
    return split is not None and (split[0] == "bfloat16"
                                  or name in BF16_PATH)


# -- the forward, prefill and decode ------------------------------------------

@pytest.mark.parametrize("split", SPLITS, ids=["f32_params", "bf16_params"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_split_prefill_and_decode_match_reference(arch, split):
    cfg = _cfg(arch, split)
    pcfg = _port(cfg)
    params, _, model = _carried(cfg)
    assert model.embed.dtype == getattr(torch, split[0])
    rng = np.random.default_rng(0)
    b, s, max_len, steps = 2, 8, 12, 3
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lj, cj = forward_prefill(cfg, params, jnp.asarray(tokens))
    lt, ct = tmodel.forward_prefill(pcfg, model, torch.from_numpy(tokens),
                                    device="cpu")
    assert lt.dtype == torch.float32
    assert _rel_err(lt, lj) <= LOGIT_REL

    # the prefill's caches written into the engine's pool as the
    # reference's engine writes them (cast into the pool's dtype), then
    # decode steps at per-row positions
    # (a mamba layer's conv tail and state as the reference's model passes
    # them on: its decode step returns the tail in the promoted dtype)
    ref_pool = init_caches(cfg, b, max_len)
    for slot, kv in cj.items():
        for key, val in kv.items():
            ref_pool[slot][key] = (
                ref_pool[slot][key].at[:, :, :s].set(
                    val.astype(ref_pool[slot][key].dtype))
                if key in ("k", "v") else val)
    pool = tmodel.init_caches(pcfg, b, max_len, device="cpu")
    for one, kv in zip(pool, ct):
        for key, val in kv.items():
            if key in ("k", "v"):
                one[key][:, :s] = to_cache_dtype_torch(val, one[key].dtype)
            else:
                one[key].copy_(val)
    kinds = [m for m, _ in cfg.block_pattern]
    if "attn" in kinds:
        layer = kinds.index("attn")
        assert pool[layer]["k"].dtype == getattr(torch, cfg.dtype)
    if "mamba" in kinds:
        layer = kinds.index("mamba")
        assert pool[layer]["ssm"].dtype == torch.float32
        # the conv tail in the dtype the reference's step leaves it in
        assert pool[layer]["conv"].dtype == torch.float32
    pos = np.array([s, s - 3], np.int32)
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        lj, ref_pool = forward_decode(cfg, params, ref_pool,
                                      jnp.asarray(tok), jnp.asarray(pos))
        lt, pool = tmodel.forward_decode(pcfg, model, pool,
                                         torch.from_numpy(tok),
                                         torch.from_numpy(pos),
                                         device="cpu")
        assert _rel_err(lt, lj) <= LOGIT_REL, (i, _rel_err(lt, lj))
        pos = pos + 1


def test_reference_scan_refuses_the_f32_params_split():
    # the reason the reference runs unrolled here (ROADMAP P19): its group
    # scan's carry turns float32 in layer 0; the port's loop runs either
    cfg = get_smoke_config("qwen3_1_7b", param_dtype="float32",
                           dtype="bfloat16")
    assert cfg.scan_groups
    params = init_params(cfg, jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="carry"):
        forward_prefill(cfg, params, jnp.zeros((1, 4), jnp.int32))
    model = tmodel.init_params(_port(cfg), device="cpu")
    logits, _ = tmodel.forward_prefill(_port(cfg), model, [[1, 2, 3, 4]],
                                       device="cpu")
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("split", SPLITS, ids=["f32_params", "bf16_params"])
def test_split_engine_tokens_match_reference(split):
    cfg = _cfg("qwen3_1_7b", split)
    pcfg = _port(cfg)
    params, _, model = _carried(cfg, seed=2)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 9, 3, 7, 6)]
    outs = {}
    for name, eng in (("ref", RefEngine(cfg, params, max_slots=3,
                                        max_len=24,
                                        tenant_weights={"gold": 2.0})),
                      ("port", ServingEngine(pcfg, model, max_slots=3,
                                             max_len=24,
                                             tenant_weights={"gold": 2.0},
                                             device="cpu"))):
        for i, p in enumerate(prompts):
            eng.submit("gold" if i % 2 else "free", p, max_new_tokens=6)
        done = eng.run(max_steps=60)
        outs[name] = {r.rid: r for r in done}
    assert set(outs["ref"]) == set(outs["port"]) == set(range(len(prompts)))
    assert model.layers[0].attn.wq.dtype == getattr(torch, split[0])
    for rid, ref in outs["ref"].items():
        got = outs["port"][rid].out_tokens
        want = ref.out_tokens
        if got == want:
            continue
        # a divergence must be a near tie of the reference's logits
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = jnp.asarray([prompts[rid] + want[:j]], jnp.int32)
        logits = np.asarray(forward_prefill(cfg, params, seq)[0][0])
        top = np.sort(logits)[-2:]
        assert top[1] - top[0] <= LOGIT_REL * np.abs(logits).max(), \
            (rid, j, got, want)


# -- training -----------------------------------------------------------------

def _batch(cfg, seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


@pytest.mark.parametrize("split", SPLITS, ids=["f32_params", "bf16_params"])
def test_split_train_step_matches_reference(split):
    cfg = _cfg("qwen3_1_7b", split)
    pcfg = _port(cfg)
    params, tree, model = _carried(cfg, seed=4)
    batch = _batch(cfg, 5)
    # the loss and every gradient, in the params' dtype
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, bt: forward_train(cfg, p, bt), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model.requires_grad_(True)
    t_loss, _ = tmodel.forward_train_torch(pcfg, model, batch, device="cpu")
    t_loss.backward()
    assert abs(float(t_loss.detach()) - float(loss)) <= \
        BOUND * abs(float(loss))
    want_grads = params_from_numpy(pcfg, jax.tree.map(np.asarray, grads))
    for name, p in model.named_parameters():
        assert p.grad.dtype == p.dtype == want_grads[name].dtype, name
        _close_leaf(p.grad, _np(want_grads[name]), f"grad {name}",
                    _rounded_torch(split, name))
    # one AdamW step over 2 microbatches (float32 accumulators, float32
    # moments), params and moments against the jitted reference's
    state = make_train_state(cfg, params, OC)
    state, metrics = jax.jit(build_train_step(cfg, OC, 2))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    model = load_params(pcfg, params_from_numpy(pcfg, tree), device="cpu")
    t_oc = topt.OptimizerConfig(**dataclasses.asdict(OC))
    t_state = make_train_state_torch(pcfg, model, t_oc, device="cpu")
    t_state, t_metrics = build_train_step_torch(pcfg, t_oc, 2,
                                                device="cpu")(t_state, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(t_metrics[key]) - float(metrics[key])) <= \
            BOUND * abs(float(metrics[key])), key
    for kind, got_all in (("params", dict(model.named_parameters())),
                          ("mu", t_state["opt"]["mu"]),
                          ("nu", t_state["opt"]["nu"])):
        src = state["params"] if kind == "params" else state["opt"][kind]
        want_all = params_from_numpy(pcfg, jax.tree.map(np.asarray, src))
        for name, want in want_all.items():
            got = got_all[name]
            assert got.dtype == want.dtype, (kind, name)
            if kind != "params":
                assert got.dtype == torch.float32
            # the second moment squares the gradient (twice its relative
            # difference), and Adam normalizes each entry, so a float32
            # param's update carries its gradient's relative difference
            # entry by entry, measured against the largest update: 2^-6
            _close_leaf(got, _np(want), f"{kind} {name}",
                        _rounded_torch(split, name),
                        2.0 ** -6 if kind == "nu" or (
                            kind == "params"
                            and got.dtype == torch.float32) else None)


# -- the decode kernel's plain version on a float32 q over bf16 caches --------

@pytest.mark.parametrize("window", [0, 5])
def test_decode_plain_f32_q_over_bf16_cache_matches_attend(window):
    cfg = dataclasses.replace(_cfg("qwen3_1_7b"), sliding_window=window)
    rng = np.random.default_rng(6)
    b, s_max, hq, hkv, d = 3, 16, 4, 2, 16
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    pos = np.array([9, 11, 7])
    # the bfloat16 caches' bytes, seen by both packages
    k16 = torch.from_numpy(kc).to(torch.bfloat16)
    v16 = torch.from_numpy(vc).to(torch.bfloat16)
    valid = jnp.arange(s_max)[None, :] <= jnp.asarray(pos)[:, None]
    want = _attend(cfg, jnp.asarray(q), jnp.asarray(k16.float().numpy(),
                                                    jnp.bfloat16),
                   jnp.asarray(v16.float().numpy(), jnp.bfloat16),
                   q_offset=int(pos.max()), kv_len_mask=valid)
    assert want.dtype == jnp.float32
    first = None
    if window:
        first = torch.full((b,), max(int(pos.max()) + 1 - window, 0),
                           dtype=torch.int32)
    before = (decode_kernel.decode_attention.launches,
              decode_kernel.decode_attention.mixed_launches)
    for fn in (decode_ref.decode_attention, decode_kernel.decode_attention):
        got = fn(torch.from_numpy(q[:, 0]), k16, v16,
                 torch.from_numpy(pos + 1).to(torch.int32), kv_start=first)
        assert got.dtype == torch.float32
        assert _rel_err(got, np.asarray(want)[:, 0]) <= 1e-5
    # on CPU tensors the wrapper took the plain version: nothing launched
    assert (decode_kernel.decode_attention.launches,
            decode_kernel.decode_attention.mixed_launches) == before


# -- remat="dots" -------------------------------------------------------------

def _train_grads(pcfg, tree, batch):
    model = load_params(pcfg, params_from_numpy(pcfg, tree), device="cpu")
    model.requires_grad_(True)
    loss, _ = tmodel.forward_train_torch(pcfg, model, batch, device="cpu")
    loss.backward()
    return float(loss.detach()), {n: p.grad
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch,split", [(a, None) for a in FAMILIES]
                         + [("qwen3_1_7b", SPLITS[0])])
def test_remat_dots_matches_full_and_reference(arch, split):
    cfg = _cfg(arch, split, remat="dots")
    pcfg = _port(cfg)
    params, tree, _ = _carried(cfg, seed=7)
    batch = _batch(cfg, 8, b=2, s=32)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, bt: forward_train(cfg, p, bt), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = params_from_numpy(pcfg, jax.tree.map(np.asarray, grads))
    dots_loss, dots = _train_grads(pcfg, tree, batch)
    full_loss, full = _train_grads(dataclasses.replace(pcfg, remat="full"),
                                   tree, batch)
    assert dots_loss == full_loss
    assert abs(dots_loss - float(loss)) <= BOUND * abs(float(loss))
    for name, g in dots.items():
        assert torch.equal(g, full[name]), name
        _close_leaf(g, _np(want[name]), f"grad {name}",
                    _rounded_torch(split, name))


def _leading_folded(shape):
    """(rows, columns) of a product's output: its leading dims folded."""
    return (int(np.prod(shape[:-1])), int(shape[-1]))


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_dots_saves_what_the_reference_saves(arch, monkeypatch):
    # the (shape, dtype) multiset of the tensors the policy saves in one
    # group against the reference's non-argument residuals under
    # dots_with_no_batch_dims_saveable: equal once the leading dims are
    # folded (a torch product of a 3-D activation folds them) and the
    # group's last product is set aside (its output is the group's output,
    # which no backward op of the group reads: jax drops it, the
    # selective checkpoint keeps it)
    from jax._src.ad_checkpoint import saved_residuals
    cfg = _cfg(arch, remat="dots")
    pcfg = _port(cfg)
    params, tree, model = _carried(cfg, seed=9)
    b, s = 2, 32
    gp = jax.tree.map(lambda a: a[0], params["groups"])
    h = jax.random.normal(jax.random.PRNGKey(1), (b, s, cfg.d_model))
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    fn = ref_blocks._remat(cfg, functools.partial(ref_blocks._group_train,
                                                  cfg))
    want = sorted(
        (_leading_folded(aval.shape), str(aval.dtype))
        for aval, why in saved_residuals(
            lambda gp, h: fn(gp, h, pos)[0].sum(), gp, h)
        if not why.startswith(("from the argument", "from a constant")))
    saved = []
    policy = tblocks.dots_saveable_policy_torch

    def recording(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == tblocks.CheckpointPolicy.MUST_SAVE \
                and not ctx.is_recompute:
            a, w = args[-2], args[-1]
            saved.append(((int(np.prod(a.shape[:-1])), int(w.shape[-1])),
                          str(a.dtype).replace("torch.", "")))
        return out
    monkeypatch.setattr(tblocks, "dots_saveable_policy_torch", recording)
    width = len(cfg.block_pattern)
    model.requires_grad_(True)
    th = torch.tensor(np.asarray(h), requires_grad=True)
    out, _ = tblocks.stack_train_torch(pcfg, model.layers[:width], th,
                                       torch.from_numpy(np.asarray(pos)))
    out.sum().backward()
    if cfg.block_pattern[-1][1] != "moe":
        # the last block's MLP down projection, or its mixer's output
        # projection where it has no MLP (an MoE block's last products
        # are the experts', which have batch dims and are not saved)
        last = ((b * s, cfg.d_model), "float32")
        assert last in saved
        saved.remove(last)
    assert sorted(saved) == want
