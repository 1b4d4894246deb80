"""Decoder blocks — the port of ``repro/models/blocks.py``: attention or
mamba mixers, each with a dense MLP, an MoE MLP or none.

The reference stacks ``cfg.groups`` copies of ``cfg.block_pattern`` with
params on a leading axis and ``lax.scan``s over them; the port keeps one
``Block`` module per layer (layer ``g * len(pattern) + slot``) and loops.
``_group_prefill`` / ``_group_decode`` become ``Block.prefill`` /
``Block.decode``, which dispatch by mixer and add ``mlp(norm(h))`` or
``moe(norm(h))[0]`` (the aux loss is a training term and is dropped, as
the reference's serving paths drop it). ``_group_train`` becomes
``Block.train_torch``, which returns the MoE aux beside h, and
``stack_train_torch`` runs the layers group by group under the
reference's ``_remat`` rule (``blocks.py:148-153``).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (Attention, attention_decode, attention_prefill,
                        attention_train_torch)
from .common import RMSNorm, constrain_torch
from .config import ModelConfig
from .mlp import MLP
from .moe import MoE, moe_apply_torch
from .ssm import Mamba, mamba_decode, mamba_train


def check_block(cfg: ModelConfig, mixer: str, mlp: str):
    """Raise ``ValueError`` for a block the reference does not have."""
    if mixer not in ("attn", "mamba") or mlp not in ("dense", "moe", "none"):
        raise ValueError(f"{cfg.name}: unknown block {(mixer, mlp)}")


class Block(torch.nn.Module):
    """One pre-norm decoder layer: h + mixer(norm(h)), then h +
    mlp(norm(h)); the mixer is ``attn`` or ``mamba``, the MLP ``dense``
    (``self.mlp``), ``moe`` (``self.moe``, as the reference's
    ``blk["moe"]``) or none."""

    def __init__(self, cfg: ModelConfig, mixer: str, mlp: str, generator,
                 dtype, device=None):
        super().__init__()
        check_block(cfg, mixer, mlp)
        self.cfg = cfg
        self.mixer = mixer
        self.norm_mixer = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        if mixer == "attn":
            self.attn = Attention(cfg, generator, dtype, device)
        else:
            self.mamba = Mamba(cfg, generator, dtype, device)
        self.mlp_kind = mlp
        if mlp != "none":
            self.norm_mlp = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        if mlp == "dense":
            self.mlp = MLP(cfg, generator, dtype, device)
        elif mlp == "moe":
            self.moe = MoE(cfg, generator, dtype, device)

    def _mlp(self, h):
        """(h + mlp(norm(h)), the MoE aux loss or None). On a mesh the
        residual is first constrained to (dp, None, None), a hint the
        reference does not need: GSPMD plans the whole graph, DTensor op
        by op, and would carry the mixer's partial sum into the norm and
        replicate the MLP's products."""
        h = constrain_torch(h, self.cfg, "dp", None, None)
        if self.mlp_kind == "dense":
            return h + self.mlp(self.norm_mlp(h)), None
        if self.mlp_kind == "moe":
            y, aux = moe_apply_torch(self.cfg, self.moe, self.norm_mlp(h))
            return h + y, aux
        return h, None

    def train_torch(self, h, positions):
        """The training forward, autograd on: returns (h, this layer's MoE
        aux loss, a float32 scalar, 0 without an MoE)."""
        h = constrain_torch(h, self.cfg, "dp", None, None)
        hn = self.norm_mixer(h)
        if self.mixer == "attn":
            h = h + attention_train_torch(self.cfg, self.attn, hn, positions)
        else:
            h = h + mamba_train(self.cfg, self.mamba, hn)
        h, aux = self._mlp(h)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h, aux

    def prefill(self, h, positions):
        """Returns (h, this layer's cache: {"k", "v"} for attention,
        {"conv", "ssm"} for mamba)."""
        h = constrain_torch(h, self.cfg, "dp", None, None)
        hn = self.norm_mixer(h)
        if self.mixer == "attn":
            y, cache = attention_prefill(self.cfg, self.attn, hn, positions)
        else:
            y, cache = mamba_train(self.cfg, self.mamba, hn,
                                   return_state=True)
        return self._mlp(h + y)[0], cache

    def decode(self, h, cache, pos):
        """One token; ``cache`` is updated in place (mamba ignores
        ``pos``). Returns (h, cache)."""
        h = constrain_torch(h, self.cfg, "dp", None, None)
        hn = self.norm_mixer(h)
        if self.mixer == "attn":
            y, cache = attention_decode(self.cfg, self.attn, hn, cache, pos)
        else:
            y, cache = mamba_decode(self.cfg, self.mamba, hn, cache)
        return self._mlp(h + y)[0], cache


def _group_train_torch(layers, h, positions):
    """One group (one copy of the block pattern) forward: (h, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in layers:
        h, a = layer.train_torch(h, positions)
        aux = aux + a
    return h, aux


def stack_train_torch(cfg: ModelConfig, layers, h, positions):
    """The layers group by group, as the reference's ``stack_train``:
    ``cfg.remat == "none"`` keeps every activation; any other value but
    ``"dots"`` (``"full"``, every config's default) recomputes each group in
    the backward (``torch.utils.checkpoint``, non-reentrant). Returns (h, the summed MoE aux loss)."""
    if cfg.remat == "dots":
        raise NotImplementedError(
            f"{cfg.name}: remat='dots' (save the matrix products' outputs) "
            f"is not in the port yet (no config the repository ships sets "
            f"it; ROADMAP.md queue 1 item 13, options no shipped config "
            f"sets)")
    width = len(cfg.block_pattern)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for g0 in range(0, len(layers), width):
        fn = functools.partial(_group_train_torch, layers[g0:g0 + width])
        if cfg.remat == "none":
            h, a = fn(h, positions)
        else:
            h, a = checkpoint(fn, h, positions, use_reentrant=False)
        aux = aux + a
    return h, aux
