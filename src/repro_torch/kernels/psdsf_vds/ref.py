"""Plain PyTorch version of the ``psdsf_vds`` kernel: per server the
minimum of x_n / (phi_n gamma[n, i]) over users and the lowest row that
attains it, with gamma <= 0 reading as ``BIG`` — what
``repro/kernels/psdsf_vds/kernel.py::_vds_kernel`` computes. The wrapper
uses it for CPU tensors; ``chip_smoke.py`` holds the kernel against it."""
from __future__ import annotations

import torch

BIG = 3.0e38


def masked_snorm(x_over_phi, gamma):
    """(N, K) normalized VDS x_over_phi[n] / gamma[n, i], ``BIG`` where
    gamma <= 0."""
    pos = gamma > 0
    one = torch.ones((), dtype=gamma.dtype, device=gamma.device)
    return torch.where(pos, x_over_phi[:, None] / torch.where(pos, gamma, one),
                       torch.full((), BIG, dtype=gamma.dtype,
                                  device=gamma.device))


def vds_argmin(x_over_phi, gamma):
    """x_over_phi: (N,) float32; gamma: (N, K) float32, N >= 1 ->
    (min (K,) float32, argmin (K,) int32); ties go to the lowest row."""
    snorm = masked_snorm(x_over_phi, gamma)
    mn = snorm.amin(dim=0)
    rows = torch.arange(snorm.shape[0], device=snorm.device,
                        dtype=torch.int32)[:, None]
    arg = torch.where(snorm <= mn[None, :], rows,
                      torch.iinfo(torch.int32).max).amin(dim=0)
    return mn, arg
