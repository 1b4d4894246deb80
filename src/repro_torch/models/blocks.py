"""Decoder blocks — the port of ``repro/models/blocks.py`` for attention
and mamba mixers with a dense MLP or none.

The reference stacks ``cfg.groups`` copies of ``cfg.block_pattern`` with
params on a leading axis and ``lax.scan``s over them; the port keeps one
``Block`` module per layer (layer ``g * len(pattern) + slot``) and loops.
``_group_prefill`` / ``_group_decode`` become ``Block.prefill`` /
``Block.decode``, which dispatch by mixer. MoE MLPs wait for their slice;
``remat`` is a training lever and does not come across.
"""
from __future__ import annotations

import torch

from .attention import Attention, attention_decode, attention_prefill
from .common import RMSNorm
from .config import ModelConfig
from .mlp import MLP
from .ssm import Mamba, mamba_decode, mamba_train


def check_block(cfg: ModelConfig, mixer: str, mlp: str):
    """Raise ``NotImplementedError`` for a block the port lacks."""
    if mlp == "moe":
        raise NotImplementedError(
            f"{cfg.name}: MoE MLPs are not ported to repro_torch yet: "
            f"ROADMAP.md queue 1 item 7, MoE")
    if mixer not in ("attn", "mamba") or mlp not in ("dense", "none"):
        raise ValueError(f"{cfg.name}: unknown block {(mixer, mlp)}")


class Block(torch.nn.Module):
    """One pre-norm decoder layer: h + mixer(norm(h)), then h +
    mlp(norm(h)); the mixer is ``attn`` or ``mamba``."""

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
        if mlp == "dense":
            self.norm_mlp = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
            self.mlp = MLP(cfg, generator, dtype, device)
        else:
            self.mlp = None

    def _mlp(self, h):
        if self.mlp is None:
            return h
        return h + self.mlp(self.norm_mlp(h))

    def prefill(self, h, positions):
        """Returns (h, this layer's cache: {"k", "v"} for attention,
        {"conv", "ssm"} for mamba)."""
        hn = self.norm_mixer(h)
        if self.mixer == "attn":
            y, cache = attention_prefill(self.cfg, self.attn, hn, positions)
        else:
            y, cache = mamba_train(self.cfg, self.mamba, hn,
                                   return_state=True)
        return self._mlp(h + y), cache

    def decode(self, h, cache, pos):
        """One token; ``cache`` is updated in place (mamba ignores
        ``pos``). Returns (h, cache)."""
        hn = self.norm_mixer(h)
        if self.mixer == "attn":
            y, cache = attention_decode(self.cfg, self.attn, hn, cache, pos)
        else:
            y, cache = mamba_decode(self.cfg, self.mamba, hn, cache)
        return self._mlp(h + y), cache
