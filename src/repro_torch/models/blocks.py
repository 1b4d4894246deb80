"""Decoder blocks — the port of ``repro/models/blocks.py`` for
``("attn", "dense")`` blocks.

The reference stacks ``cfg.groups`` copies of ``cfg.block_pattern`` with
params on a leading axis and ``lax.scan``s over them; the port keeps one
``Block`` module per layer (layer ``g * len(pattern) + slot``) and loops.
``_group_prefill`` / ``_group_decode`` become ``Block.prefill`` /
``Block.decode``. Mamba mixers and MoE MLPs wait for their slices; ``remat``
is a training lever and does not come across.
"""
from __future__ import annotations

import torch

from .attention import Attention, attention_decode, attention_prefill
from .common import RMSNorm
from .config import ModelConfig
from .mlp import MLP


def check_block(cfg: ModelConfig, mixer: str, mlp: str):
    """Raise ``NotImplementedError`` for a block the port lacks."""
    if mixer == "mamba":
        raise NotImplementedError(
            f"{cfg.name}: mamba mixers wait for models/ssm and "
            f"kernels/ssd_scan (ROADMAP, next slice)")
    if mlp == "moe":
        raise NotImplementedError(
            f"{cfg.name}: MoE MLPs wait for models/moe (ROADMAP, next slice)")
    if mixer != "attn" or mlp not in ("dense", "none"):
        raise ValueError(f"{cfg.name}: unknown block {(mixer, mlp)}")


class Block(torch.nn.Module):
    """One pre-norm decoder layer: h + attn(norm(h)), then h + mlp(norm(h))."""

    def __init__(self, cfg: ModelConfig, mixer: str, mlp: str, generator,
                 dtype, device=None):
        super().__init__()
        check_block(cfg, mixer, mlp)
        self.cfg = cfg
        self.norm_mixer = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = Attention(cfg, generator, dtype, device)
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
        """Returns (h, this layer's {"k", "v"} cache)."""
        y, kv = attention_prefill(self.cfg, self.attn, self.norm_mixer(h),
                                  positions)
        return self._mlp(h + y), kv

    def decode(self, h, cache, pos):
        """One token; ``cache`` is updated in place. Returns (h, cache)."""
        y, cache = attention_decode(self.cfg, self.attn, self.norm_mixer(h),
                                    cache, pos)
        return self._mlp(h + y), cache
