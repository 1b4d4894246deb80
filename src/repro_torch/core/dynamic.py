"""Scheduler-tick telemetry of the port: the Eq. 16 per-server min-VDS.

Only ``min_vds_guarded`` of ``repro/core/dynamic.py`` is ported in this
slice (the tick layer itself is ROADMAP.md queue 1 item 9). It is the
reduction ``DistributedPSDSF.min_vds`` and the churn simulator's telemetry
call in the reference, and it runs through the Hopper ``psdsf_vds`` kernel
for tensors on the card.
"""
from __future__ import annotations

import torch

from ..device import DeviceLike, resolve_device, to_device
from ..kernels.psdsf_vds.ops import min_vds


def min_vds_guarded(x, weights, gamma, active, *, device: DeviceLike = None):
    """Per server, min_n x_n / (phi_n gamma[n, i]) over the active users
    with positive weight, and the user attaining it.

    x (N, K), weights (N,), gamma (N, K), active (N,) bool: tensors or
    numpy arrays, moved to ``device`` (default ``cuda``). The mask is
    applied BEFORE the division, so a zero-weight user is excluded exactly
    like an inactive one instead of turning a server's minimum into inf or
    NaN; a server without any such user reports 3e38. Returns (min (K,)
    float32, argmin (K,) int32) on ``device``.
    """
    dev = resolve_device(device)
    x, weights, gamma = (to_device(a, dev) for a in (x, weights, gamma))
    mask = to_device(active, dev, torch.bool) & (weights > 0)
    one = torch.ones((), dtype=weights.dtype, device=dev)
    x_over_phi = torch.where(mask, x.sum(dim=1) / torch.where(mask, weights,
                                                              one),
                             torch.zeros((), dtype=x.dtype, device=dev))
    return min_vds(x_over_phi, torch.where(mask[:, None], gamma,
                                           torch.zeros((), dtype=gamma.dtype,
                                                       device=dev)))
