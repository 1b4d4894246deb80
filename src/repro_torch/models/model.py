"""The language model: embed -> layers -> final norm -> logits — the port
of ``repro/models/model.py`` for serving.

Entry points:
  init_params(cfg, seed, generator=None, device=None)  -> Transformer
  forward_prefill(cfg, params, tokens, positions=None, device=None)
                                                -> (last_logits, caches)
  forward_decode(cfg, params, caches, token, pos, device=None)
                                                -> (logits, caches)
  init_caches(cfg, batch, max_len, device=None) -> caches

``params`` is a ``Transformer`` module (its state dict mirrors the
reference's pytree, see ``convert.py``); ``caches`` is a list with one dict
per layer, by mixer: ``{"k", "v"}`` (B, S_max, Hkv, D) tensors for
attention, ``{"conv": (B, ssm_conv - 1, d_inner + 2 N), "ssm": (B, H, P,
N) float32}`` for mamba; ``forward_decode`` updates them in place. Each
entry point runs on the card unless ``device="cpu"`` is passed, and
``params`` must live there. Tied
embeddings only share the table; padded vocab slots read -1e9.
``forward_train`` waits for the training slice.
"""
from __future__ import annotations

import torch

from ..device import DeviceLike, resolve_device
from .blocks import Block
from .common import RMSNorm, dtype_of, embed_init, rmsnorm
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
                f"dtype ({cfg.param_dtype} != {cfg.dtype})")
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.frontend} frontend waits for its "
                f"config (ROADMAP.md queue 1 item 9, M-RoPE and the frontend "
                f"stubs)")
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


def _embed(cfg: ModelConfig, params: Transformer, tokens):
    return params.embed[tokens].to(dtype_of(cfg.dtype))


def _logits(cfg: ModelConfig, params: Transformer, h):
    h = rmsnorm(params.final_norm.scale, h, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.unembed
    logits = (h @ w).float()
    if cfg.vocab_padded != cfg.vocab_size:    # mask padded vocab slots
        logits[..., cfg.vocab_size:] = -1e9
    return logits


@torch.no_grad()
def forward_prefill(cfg: ModelConfig, params: Transformer, tokens,
                    positions=None, device: DeviceLike = None):
    """tokens: (B, S) ints. Returns (logits at the last position (B, V)
    float32, caches: one dict per layer, {"k", "v"} (B, S, Hkv, D) for
    attention, {"conv", "ssm"} for mamba)."""
    dev = _check_params(params, device)
    tokens = torch.as_tensor(tokens, device=dev).long()
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=dev).expand(
            tokens.shape)
    else:
        positions = torch.as_tensor(positions, device=dev)
    h = _embed(cfg, params, tokens)
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


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: DeviceLike = None):
    """Zeroed decode caches, one dict per layer as ``init_group_cache``
    builds them: {"k", "v"} (batch, max_len, Hkv, D) in the compute dtype
    for attention; for mamba {"conv": (batch, ssm_conv - 1, d_inner + 2 N)
    in the compute dtype, "ssm": (batch, H, P, N) float32}."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    pattern = cfg.block_pattern
    caches = []
    for i in range(cfg.num_layers):
        if pattern[i % len(pattern)][0] == "attn":
            shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            conv = (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
            ssm = (batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
            caches.append({
                "conv": torch.zeros(conv, dtype=dtype, device=dev),
                "ssm": torch.zeros(ssm, dtype=torch.float32, device=dev)})
    return caches
