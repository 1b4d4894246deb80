"""Dense MLPs — SwiGLU / GeGLU (gated) and plain GELU — the port of
``repro/models/mlp.py``. Weights keep the reference's (in, out) layout and
are applied as ``x @ W``."""
from __future__ import annotations

import torch

from .common import act_fn, dense_init
from .config import ModelConfig


def _param(t):
    return torch.nn.Parameter(t, requires_grad=False)


class MLP(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, generator, dtype, device=None,
                 d_ff: int | None = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        self.gated = cfg.mlp_type in ("swiglu", "geglu")
        self.act = act_fn(cfg.mlp_type)
        if self.gated:
            self.wi_gate = _param(dense_init(generator, (cfg.d_model, d_ff),
                                             dtype, device=device))
            self.wi_up = _param(dense_init(generator, (cfg.d_model, d_ff),
                                           dtype, device=device))
        else:
            self.wi = _param(dense_init(generator, (cfg.d_model, d_ff), dtype,
                                        device=device))
        self.wo = _param(dense_init(generator, (d_ff, cfg.d_model), dtype,
                                    device=device))

    def forward(self, x):
        if self.gated:
            h = self.act(x @ self.wi_gate) * (x @ self.wi_up)
        else:
            h = self.act(x @ self.wi)
        return h @ self.wo
