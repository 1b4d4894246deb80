"""``min_vds``: the Eq. 16 reduction for any (N, K), the port of
``repro/kernels/psdsf_vds/ops.py::min_vds_padded``. The kernel masks its
ragged edges itself, so nothing is padded; an empty user axis reads as the
reference's padded answer (``BIG``, row 0)."""
from __future__ import annotations

import torch

from .kernel import vds_argmin
from .ref import BIG


def min_vds(x_over_phi, gamma):
    """(min normalized VDS (K,) float32, argmin user (K,) int32) per server
    for x_over_phi (N,) and gamma (N, K) tensors on one device, cast to
    float32 as the kernel computes in float32."""
    gamma = gamma.to(torch.float32).contiguous()
    x_over_phi = x_over_phi.to(torch.float32).contiguous()
    if gamma.shape[0] == 0:
        k = gamma.shape[1]
        return (torch.full((k,), BIG, dtype=torch.float32,
                           device=gamma.device),
                torch.zeros((k,), dtype=torch.int32, device=gamma.device))
    return vds_argmin(x_over_phi, gamma)
