"""The port's device rule: the card by default, the CPU only on request.

Every entry point takes ``device=None`` and resolves it here. ``None``
means ``"cuda"``; without a CUDA device that raises instead of falling back
silently, so a run that was meant for the card never measures the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``cuda``. Raises
    ``RuntimeError`` for a CUDA device when CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device: {dev}")
    return dev


def to_device(a, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` (tensor or array-like) as a contiguous tensor on ``device``;
    arrays are copied, so read-only buffers (a JAX result) are fine."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))
    return t.to(device=device, dtype=dtype).contiguous()
