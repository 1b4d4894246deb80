"""The language model: embed -> layers -> final norm -> logits — the port
of ``repro/models/model.py``.

Entry points:
  init_params(cfg, seed, generator=None, device=None)  -> Transformer
  forward_train_torch(cfg, params, batch, device=None)  -> (loss, metrics)
  forward_prefill(cfg, params, tokens, positions=None, extra_embeds=None,
                  extra_mask=None, device=None) -> (last_logits, caches)
  forward_decode(cfg, params, caches, token, pos, device=None)
                                                -> (logits, caches)
  init_caches(cfg, batch, max_len, device=None) -> caches
  abstract_params_torch(cfg, device="meta"), abstract_caches_torch(...)
                                 -> shapes only, for launch/dryrun.py

``params`` is a ``Transformer`` module (its state dict mirrors the
reference's pytree, see ``convert.py``); ``caches`` is a list with one dict
per layer, by mixer: ``{"k", "v"}`` (B, S_max, Hkv, D) tensors for
attention, ``{"conv": (B, ssm_conv - 1, d_inner + 2 N), "ssm": (B, H, P,
N) float32}`` for mamba; ``forward_decode`` updates them in place.
Positions are (B, S), or (3, B, S) temporal/height/width ids under M-RoPE
(``rope_type="mrope"``); by default every row counts from 0 and, under
M-RoPE, t == h == w. The frontend stubs (``frontend="vision_stub"`` or
``"audio_stub"``) take precomputed patch or frame embeddings through
``forward_prefill``'s ``extra_embeds`` at the positions ``extra_mask``
selects; ``forward_decode`` takes token ids only, as the reference's. Each
entry point runs on the card unless ``device="cpu"`` is passed, and
``params`` must live there. Tied
embeddings only share the table; padded vocab slots read -1e9. A model
sharded by ``launch/sharding.py::distribute_state_torch`` (DTensor params,
``cfg.dp_axes``/``tp_axis`` set) runs the same entry points under
``implicit_replication()``; its embedding lookup and loss go
vocab-parallel.

``forward_prefill`` and ``forward_decode`` run without autograd;
``forward_train_torch`` runs with it, through each attention layer's
``_FlashTrain`` (or ``_attend``) and each mamba layer's differentiable
``ssd_chunked_train``, the layers grouped under ``cfg.remat``. The params a
``Transformer`` is built with are frozen (``requires_grad=False``) for
serving; ``train.step.make_train_state_torch`` makes them trainable.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..device import DeviceLike, resolve_device
from .blocks import Block, stack_train_torch
from .common import (RMSNorm, constrain_torch, dtype_of, embed_init,
                     layout_of_torch, local_region_torch, rmsnorm,
                     unshard_dp_torch)
from .config import ModelConfig


class Transformer(torch.nn.Module):
    """Parameters of one model: ``embed`` (vocab_padded, d_model),
    ``final_norm``, ``layers`` (one ``Block`` per layer, group-major),
    ``unembed`` (d_model, vocab_padded) when embeddings are untied. With
    ``generator=None`` the weights are left uninitialized for a caller
    that loads a state dict."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        if cfg.dtype != cfg.param_dtype:
            raise NotImplementedError(
                f"{cfg.name}: the port runs params and activations in one "
                f"dtype ({cfg.param_dtype} != {cfg.dtype}; no config the "
                f"repository ships splits them; ROADMAP.md queue 1 item 13, "
                f"options no shipped config sets)")
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        self.embed = torch.nn.Parameter(
            embed_init(generator, (cfg.vocab_padded, cfg.d_model), dtype,
                       device=device), requires_grad=False)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        pattern = cfg.block_pattern
        self.layers = torch.nn.ModuleList(
            Block(cfg, *pattern[i % len(pattern)], generator, dtype, device)
            for i in range(cfg.groups * len(pattern)))
        if not cfg.tie_embeddings:
            self.unembed = torch.nn.Parameter(
                embed_init(generator, (cfg.d_model, cfg.vocab_padded), dtype,
                           std=1.0 / cfg.d_model ** 0.5, device=device),
                requires_grad=False)


def init_params(cfg: ModelConfig, seed: int = 0, *, generator=None,
                device: DeviceLike = None) -> Transformer:
    """A ``Transformer`` initialized on ``device`` from ``generator`` (by
    default a generator on that device seeded with ``seed``). The numbers
    differ from the reference's ``jax.random`` init of the same seed; the
    tests carry the reference's params across with ``convert.py``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, generator, dev)


def _check_params(params: Transformer, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if params.embed.device.type != dev.type:
        raise ValueError(f"params live on {params.embed.device}, the call "
                         f"asks for {dev}")
    return params.embed.device


def _default_positions(cfg: ModelConfig, tokens):
    """(B, S) positions counting from 0; under M-RoPE (3, B, S), with t ==
    h == w (text), as the reference's ``_default_positions``."""
    pos = torch.arange(tokens.shape[1], device=tokens.device).expand(
        tokens.shape)
    if cfg.rope_type == "mrope":
        pos = pos[None].expand((3,) + tuple(tokens.shape))
    return pos


def _inputs(cfg: ModelConfig, dev, tokens, positions, extra_embeds,
            extra_mask):
    """The entry points' inputs as tensors on ``dev``: int64 tokens,
    positions (``_default_positions`` when None), the frontend stub's
    embeddings and bool mask (or None)."""
    tokens = torch.as_tensor(tokens, device=dev).long()
    positions = (_default_positions(cfg, tokens) if positions is None
                 else torch.as_tensor(positions, device=dev))
    if extra_embeds is not None:
        extra_embeds = torch.as_tensor(extra_embeds, device=dev)
        extra_mask = torch.as_tensor(extra_mask, device=dev).bool()
    return tokens, positions, extra_embeds, extra_mask


def _embed(cfg: ModelConfig, params: Transformer, tokens, extra_embeds=None,
           extra_mask=None):
    """The table's rows for ``tokens``; with a frontend stub, the positions
    ``extra_mask`` (B, S) selects take ``extra_embeds`` (B, S, D) cast to the
    table's dtype instead; then the compute dtype."""
    table = unshard_dp_torch(params.embed, cfg)
    h = (_embed_sharded_torch(table, tokens) if isinstance(table, DTensor)
         else table[tokens])
    if cfg.frontend != "none" and extra_embeds is not None:
        h = torch.where(extra_mask[..., None],
                        extra_embeds.to(h.dtype), h)
    return constrain_torch(h.to(dtype_of(cfg.dtype)), cfg, "dp", None, None)


def _embed_sharded_torch(table, tokens):
    """``table[tokens]`` for a vocab-sharded DTensor table, the
    vocab-parallel way: each device looks up the tokens its vocab shard
    holds (zeros elsewhere) in ``local_region_torch``, and the shards'
    rows are summed by a DTensor reduction. DTensor's own rule for the
    lookup's backward (an accumulating ``index_put``) fails in some torch
    releases."""
    mesh = table.device_mesh
    vl, dl = layout_of_torch(table)
    tl = layout_of_torch(tokens) if hasattr(tokens, "device_mesh") else (
        (), ())
    names = mesh.mesh_dim_names

    def part(table, tokens):
        coord = mesh.get_coordinate() or [0] * mesh.ndim
        shard = 0
        for a in vl:
            i = names.index(a)
            shard = shard * mesh.size(i) + coord[i]
        v = table.shape[0]
        local = tokens.long() - shard * v
        inside = ((local >= 0) & (local < v))[..., None]
        rows = table[local.clamp(0, v - 1)]
        return torch.where(inside, rows, torch.zeros((), dtype=rows.dtype,
                                                     device=rows.device))[None]

    rows = local_region_torch("embedding (vocab-parallel parts)", part,
                              ((vl, dl), tl), ((vl,) + tl + (dl,),),
                              table, tokens)
    return rows.sum(dim=0)


def _logits(cfg: ModelConfig, params: Transformer, h):
    # (dp, None, None) before the unembedding, a hint for DTensor as in
    # ``Block._mlp``
    h = rmsnorm(params.final_norm.scale,
                constrain_torch(h, cfg, "dp", None, None), cfg.norm_eps)
    w = unshard_dp_torch(params.embed if cfg.tie_embeddings
                         else params.unembed, cfg)
    w = w.T if cfg.tie_embeddings else w
    logits = constrain_torch((h @ w).float(), cfg, "dp", None, "tp")
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    if isinstance(logits, DTensor):     # no slice write on a sharded dim
        pad = torch.arange(cfg.vocab_padded, device=logits.device)
        return logits.masked_fill_(pad >= cfg.vocab_size, -1e9)
    logits[..., cfg.vocab_size:] = -1e9    # mask padded vocab slots
    return logits


def softmax_xent_torch(logits, labels, z_loss: float = 1e-4):
    """Cross entropy with z-loss per token, as the reference's
    ``softmax_xent``: logits float32 (B, S, V), labels int (B, S) ->
    ``lse - gold + z_loss lse^2`` (B, S)."""
    if isinstance(logits, DTensor):
        lse, gold = _xent_parts_sharded_torch(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold + z_loss * lse * lse


def _xent_parts_sharded_torch(logits, labels):
    """(lse, gold) of vocab-sharded DTensor logits (B, S, V), the
    vocab-parallel way: each device reduces its vocab shard (its max, sum
    of exps and the label's logit where the label falls in it) in
    ``local_region_torch``, and the shards' parts merge with DTensor
    reductions; DTensor's own ``logsumexp`` and ``gather`` would gather
    the whole vocab on every device."""
    mesh = logits.device_mesh
    bl, sl, vl = layout_of_torch(logits)
    names = mesh.mesh_dim_names

    def part(logits, labels):
        coord = mesh.get_coordinate() or [0] * mesh.ndim
        shard = 0
        for a in vl:
            i = names.index(a)
            shard = shard * mesh.size(i) + coord[i]
        v = logits.shape[-1]
        local = labels.long() - shard * v
        inside = (local >= 0) & (local < v)
        gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])
        gold = torch.where(inside, gold[..., 0], 0.0)
        m = logits.detach().amax(dim=-1)
        s = torch.exp(logits - m[..., None]).sum(dim=-1)
        return m[None], s[None], gold[None]

    part_lay = (vl, bl, sl)
    m, s, gold = local_region_torch(
        "softmax_xent (vocab-parallel parts)", part, ((bl, sl, vl), (bl, sl)),
        (part_lay,) * 3, logits, labels)
    m_all = m.amax(dim=0)
    lse = m_all + torch.log((s * torch.exp(m - m_all)).sum(dim=0))
    return lse, gold.sum(dim=0)


def forward_train_torch(cfg: ModelConfig, params: Transformer, batch,
                        device: DeviceLike = None):
    """The reference's ``forward_train``, with autograd: ``batch`` holds
    tokens (B, S) and labels (B, S) ints, optionally positions ((B, S), or
    (3, B, S) under M-RoPE; default ``_default_positions``) and, for a
    frontend stub, extra_embeds (B, S, D) with the bool extra_mask (B, S).
    Returns (loss, metrics): ``loss = mean(xent) + 0.01 aux`` (a float32
    scalar to backpropagate), metrics ``loss``, ``nll`` (the mean per-token
    loss, z-loss included, as the reference names it) and ``aux_loss`` (the
    MoE layers' summed load-balancing loss), all float32 scalars."""
    dev = _check_params(params, device)
    tokens, positions, extra_embeds, extra_mask = _inputs(
        cfg, dev, batch["tokens"], batch.get("positions"),
        batch.get("extra_embeds"), batch.get("extra_mask"))
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    h = _embed(cfg, params, tokens, extra_embeds, extra_mask)
    h, aux = stack_train_torch(cfg, params.layers, h, positions)
    per_tok = softmax_xent_torch(_logits(cfg, params, h), labels)
    nll = per_tok.mean()
    loss = nll + 0.01 * aux
    return loss, {"loss": loss, "nll": nll, "aux_loss": aux}


@torch.no_grad()
def forward_prefill(cfg: ModelConfig, params: Transformer, tokens,
                    positions=None, extra_embeds=None, extra_mask=None,
                    device: DeviceLike = None):
    """tokens: (B, S) ints; positions (B, S), or (3, B, S) under M-RoPE
    (default: ``_default_positions``); for a frontend stub, ``extra_embeds``
    (B, S, D) and the bool ``extra_mask`` (B, S) of the positions they fill.
    Returns (logits at the last position (B, V) float32, caches: one dict
    per layer, {"k", "v"} (B, S, Hkv, D) for attention, {"conv", "ssm"}
    for mamba)."""
    dev = _check_params(params, device)
    tokens, positions, extra_embeds, extra_mask = _inputs(
        cfg, dev, tokens, positions, extra_embeds, extra_mask)
    h = _embed(cfg, params, tokens, extra_embeds, extra_mask)
    caches = []
    for layer in params.layers:
        h, kv = layer.prefill(h, positions)
        caches.append(kv)
    return _logits(cfg, params, h[:, -1:, :])[:, 0, :], caches


@torch.no_grad()
def forward_decode(cfg: ModelConfig, params: Transformer, caches, token,
                   pos, device: DeviceLike = None):
    """One decode step. token: (B,) ints; pos: () or (B,) int write index
    per sequence. ``caches`` is updated in place. Returns (logits (B, V)
    float32, caches)."""
    dev = _check_params(params, device)
    token = torch.as_tensor(token, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).expand(token.shape[0])
    h = _embed(cfg, params, token[:, None])
    for layer, cache in zip(params.layers, caches):
        h, _ = layer.decode(h, cache, pos)
    return _logits(cfg, params, h)[:, 0, :], caches


def _cache_layout_torch(cfg: ModelConfig, batch: int, max_len: int):
    """One dict a layer, name -> (shape, dtype), as ``init_caches`` fills
    them: attention K/V in ``cfg.cache_dtype`` where it is set (the
    reference's ``init_group_cache``, ``blocks.py:55-57``), else the
    compute dtype."""
    dtype = dtype_of(cfg.dtype)
    kv_dtype = dtype_of(cfg.cache_dtype) if cfg.cache_dtype else dtype
    pattern = cfg.block_pattern
    layout = []
    for i in range(cfg.num_layers):
        if pattern[i % len(pattern)][0] == "attn":
            shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            layout.append({"k": (shape, kv_dtype), "v": (shape, kv_dtype)})
        else:
            conv = (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
            ssm = (batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
            layout.append({"conv": (conv, dtype),
                           "ssm": (ssm, torch.float32)})
    return layout


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: DeviceLike = None):
    """Zeroed decode caches, one dict per layer as ``init_group_cache``
    builds them: {"k", "v"} (batch, max_len, Hkv, D) in ``cfg.cache_dtype``
    (the compute dtype where it is unset) for attention; for mamba
    {"conv": (batch, ssm_conv - 1, d_inner + 2 N) in the compute dtype,
    "ssm": (batch, H, P, N) float32}."""
    dev = resolve_device(device)
    return [{k: torch.zeros(shape, dtype=dt, device=dev)
             for k, (shape, dt) in layer.items()}
            for layer in _cache_layout_torch(cfg, batch, max_len)]


def abstract_params_torch(cfg: ModelConfig, device="meta") -> Transformer:
    """A ``Transformer`` of ``cfg`` with uninitialized weights on
    ``device``, the meta device by default (shapes and dtypes, no
    storage), for the dry run: the reference's ``abstract_params``. It
    does not go through ``resolve_device``, which refuses "meta"; under a
    ``FakeTensorMode`` pass "cpu" for fake CPU tensors."""
    return Transformer(cfg, None, torch.device(device))


def abstract_caches_torch(cfg: ModelConfig, batch: int, max_len: int,
                          device="meta"):
    """``init_caches``' list as empty tensors on ``device`` (meta by
    default): the reference's ``abstract_caches``."""
    return [{k: torch.empty(shape, dtype=dt, device=device)
             for k, (shape, dt) in layer.items()}
            for layer in _cache_layout_torch(cfg, batch, max_len)]
