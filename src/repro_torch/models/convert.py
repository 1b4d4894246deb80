"""Carry the reference's parameters across: the JAX params pytree (as
numpy arrays) -> the port's state dict.

The port keeps the reference's (in, out) projection layout (``x @ W``), so
nothing is transposed; each layer leaf's leading ``groups`` axis is
unstacked into per-layer tensors (layer ``g * len(pattern) + slot``); the
norm ``scale`` leaves are zeros-based (applied as ``1 + scale``) in both
packages and are carried as they are. Every leaf keeps its dtype: bfloat16
leaves (numpy's ``ml_dtypes.bfloat16``) arrive as ``torch.bfloat16``, and
the mamba mixer's ``A_log``, ``D`` and ``dt_bias`` stay float32 in a
bfloat16 model, as ``init_mamba`` makes them.
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
