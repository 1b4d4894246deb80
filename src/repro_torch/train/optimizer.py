"""AdamW with float32 update math whatever the storage dtype, global-norm
clipping and a linear-warmup + cosine schedule: the port of
``repro/train/optimizer.py``.

The state is ``{"mu": {name: tensor}, "nu": {name: tensor}, "step": int64
scalar tensor}``, the moments keyed by the names of ``Transformer``'s
parameters (its state-dict keys) and stored in ``state_dtype``. The update
is plain tensor ops, one parameter at a time, in place on the parameters
and the moments (the reference returns new pytrees); every scalar (lr, the
bias corrections, the clip scale) stays a device tensor, so a step reads
nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.common import dtype_of


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 200
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


def lr_schedule_torch(oc: OptimizerConfig, step):
    """The learning rate at ``step`` (an int tensor), float32: linear warmup
    from 0 over ``warmup_steps``, then cosine down to ``min_lr_ratio`` x
    peak at ``decay_steps`` and flat after, as the reference's
    ``schedule``."""
    step = torch.as_tensor(step).float()
    warm = step / max(oc.warmup_steps, 1)
    prog = ((step - oc.warmup_steps)
            / max(oc.decay_steps - oc.warmup_steps, 1)).clamp(0, 1)
    cos = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return oc.peak_lr * torch.where(step < oc.warmup_steps, warm, cos)


def init_opt_state_torch(params: dict, oc: OptimizerConfig):
    """Zero moments in ``state_dtype`` beside each of ``params`` (name ->
    tensor; a DTensor parameter gets DTensor moments of its placements),
    and step 0 on their device."""
    dt = dtype_of(oc.state_dtype)
    device = next(iter(params.values())).device
    return {"mu": {n: torch.zeros_like(p, dtype=dt, requires_grad=False)
                   for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=dt, requires_grad=False)
                   for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int64, device=device)}


def global_norm_torch(grads: dict) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every tensor of ``grads``
    (name -> tensor)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


@torch.no_grad()
def adamw_update_torch(params: dict, grads: dict, opt_state,
                       oc: OptimizerConfig):
    """One AdamW step, the reference's ``adamw_update``: clip by the
    global norm, moments and update in float32, bias corrections from the
    new step, decoupled weight decay on the float32 param, cast back to
    the param's dtype. ``params`` and ``grads`` map names to tensors;
    ``params`` and ``opt_state``'s moments are updated in place. Returns
    (opt_state with the new step, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    lr = lr_schedule_torch(oc, step)
    gnorm = global_norm_torch(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = opt_state["mu"][name], opt_state["nu"][name]
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g.square()
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + oc.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (delta + oc.weight_decay * p32))
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"] = step
    return opt_state, {"lr": lr, "grad_norm": gnorm}
