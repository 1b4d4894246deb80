"""Carry the reference's parameters across: the JAX params pytree (as
numpy arrays) -> the port's state dict.

The port keeps the reference's (in, out) projection layout (``x @ W``), so
nothing is transposed; each layer leaf's leading ``groups`` axis is
unstacked into per-layer tensors (layer ``g * len(pattern) + slot``); the
norm ``scale`` leaves are zeros-based (applied as ``1 + scale``) in both
packages and are carried as they are. Every leaf keeps its dtype: bfloat16
leaves (numpy's ``ml_dtypes.bfloat16``) arrive as ``torch.bfloat16``, and
the mamba mixer's ``A_log``, ``D`` and ``dt_bias`` and the MoE
``router`` (D, E) stay float32 in a bfloat16 model, as ``init_mamba`` and
``init_moe`` make them. The MoE expert stacks (G, E, D, F) / (G, E, F, D)
lose their groups axis like every other leaf and keep the expert axis:
``layers.<i>.moe.wi_gate`` is (E, D, F). ``opt_state_from_numpy`` carries
the reference's AdamW state (its moments have the params' tree) the same
way.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .model import Transformer


def _tensor(arr) -> torch.Tensor:
    """A CPU tensor holding a copy of ``arr`` in its own dtype."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":   # from_numpy rejects ml_dtypes bf16
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def params_from_numpy(cfg: ModelConfig, tree) -> Dict[str, torch.Tensor]:
    """The reference params pytree (nested dicts of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's state dict of CPU
    tensors, keyed like ``Transformer.state_dict()``."""
    width = len(cfg.block_pattern)
    state = {}
    for name, arr in _flatten({k: v for k, v in tree.items()
                               if k != "groups"}):
        state[name] = _tensor(arr)
    for slot, blk in tree["groups"].items():
        for name, arr in _flatten(blk):
            arr = np.asarray(arr)
            if arr.shape[0] != cfg.groups:
                raise ValueError(f"groups.{slot}.{name}: leading axis "
                                 f"{arr.shape[0]} != groups {cfg.groups}")
            for g in range(cfg.groups):
                state[f"layers.{g * width + int(slot)}.{name}"] = \
                    _tensor(arr[g])
    return state


def load_params(cfg: ModelConfig, state: Dict[str, torch.Tensor],
                device: DeviceLike = None) -> Transformer:
    """A ``Transformer`` on ``device`` holding ``state`` (every key must
    match: ``load_state_dict(strict=True)``)."""
    model = Transformer(cfg, None, resolve_device(device))
    model.load_state_dict(state, strict=True)
    return model


def opt_state_from_numpy(cfg: ModelConfig, tree,
                         device: DeviceLike = None):
    """The reference's optimizer state (``{"mu", "nu"}`` pytrees shaped
    like the params, and ``step``) as the port's: the moments keyed like
    the params' state dict, each in its own dtype, and ``step`` an int64
    scalar, all on ``device``."""
    dev = resolve_device(device)
    return {"mu": {k: v.to(dev) for k, v in
                   params_from_numpy(cfg, tree["mu"]).items()},
            "nu": {k: v.to(dev) for k, v in
                   params_from_numpy(cfg, tree["nu"]).items()},
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int64, device=dev)}
