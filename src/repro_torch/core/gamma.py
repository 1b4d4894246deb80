"""Per-server monopolization counts gamma (Eq. 7), in numpy and in torch.

``gamma_matrix`` is the port's copy of ``repro.core.gamma.gamma_matrix``
(host numpy, bit-identical); ``gamma_matrix_torch`` is the tensor twin of
``repro.core.psdsf_jax.gamma_matrix_jnp`` for pipelines that stay on the
device.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import AllocationProblem

_BIG = 1e30


def gamma_matrix(problem: AllocationProblem) -> np.ndarray:
    """gamma[n, i] = delta[n, i] * min_{r: d[n,r]>0} c[i, r] / d[n, r].

    A user demanding a resource a server lacks (c == 0) gets gamma == 0,
    i.e. is implicitly ineligible there.
    """
    d = problem.demands            # (N, R)
    c = problem.capacities         # (K, R)
    with np.errstate(divide="ignore"):
        ratio = c[None, :, :] / np.where(d > 0, d, np.inf)[:, None, :]
    ratio = np.where(d[:, None, :] > 0, ratio, np.inf)
    g = ratio.min(axis=2)
    g = np.where(np.isfinite(g), g, 0.0)
    return g * problem.eligibility


def gamma_matrix_torch(demands: torch.Tensor, capacities: torch.Tensor,
                       eligibility: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`gamma_matrix` on (N, R), (K, R), (N, K)
    tensors of one dtype and device."""
    d = demands[:, None, :]
    ratio = torch.where(d > 0, capacities[None, :, :] / d.clamp(min=1e-300),
                        torch.full_like(d, _BIG))
    g = ratio.amin(dim=2)
    g = torch.where(g >= _BIG * 0.5, torch.zeros_like(g), g)
    return g * eligibility
