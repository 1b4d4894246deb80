"""Plain PyTorch version of the ``ssd_scan`` kernel: the chunked SSD of
``repro/kernels/ssd_scan/kernel.py::_ssd_kernel`` (and of
``repro/models/ssm.py::_ssd_chunked``, whose final state it also returns),
in float32, in the kernel's (B, H, S, P) layout. The wrapper uses it for
CPU tensors; ``chip_smoke.py`` holds the kernel against it.

Any S is taken: the ragged last chunk is padded with dt = 0 and x = 0,
which leaves the state exactly unchanged (decay exp(0) = 1, no update),
and the padded rows are cut from y. ``ssd_scan_sequential`` is the
counterpart of the reference's oracle ``ref.py::ssd_scan_ref``: the
recurrence one timestep at a time, for the tests."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_scan(x, dt, a, b_mat, c_mat, *, chunk: int = 128, init_state=None):
    """x: (B, H, S, P); dt: (B, H, S) post-softplus; a: (H,) negative;
    b_mat, c_mat: (B, S, N); init_state: (B, H, P, N) or None (zeros).
    Returns (y (B, H, S, P) in x's dtype, final state (B, H, P, N)
    float32)."""
    bsz, h, s, p = x.shape
    n = b_mat.shape[-1]
    q = chunk
    nc = -(-s // q)
    pad = nc * q - s
    xf = F.pad(x.float(), (0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, pad))
    bf = F.pad(b_mat.float(), (0, 0, 0, pad))
    cf = F.pad(c_mat.float(), (0, 0, 0, pad))
    xc = xf.reshape(bsz, h, nc, q, p)
    dtc = dtf.reshape(bsz, h, nc, q)
    bc = bf.reshape(bsz, nc, q, n)
    cc = cf.reshape(bsz, nc, q, n)

    seg = torch.cumsum(dtc * a.float()[None, :, None, None], dim=-1)
    # intra-chunk ("diagonal") term: attention-like products
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)          # (B, nc, Q, Q)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg[..., :, None] - seg[..., None, :])  # (B,H,nc,Q,K)
    w = (scores[:, None] * torch.where(causal, decay, 0.0)
         * dtc[..., None, :])
    y = torch.einsum("bhcqk,bhckp->bhcqp", w, xc)

    # chunk summaries: Z_c = sum_j exp(seg_last - seg_j) dt_j x_j b_j^T
    last = seg[..., -1:]
    wstate = torch.exp(last - seg) * dtc                      # (B, H, nc, Q)
    z = torch.einsum("bhcq,bhcqp,bcqn->bhcpn", wstate, xc, bc)
    chunk_decay = torch.exp(last[..., 0])                     # (B, H, nc)

    # inter-chunk recurrence, then the off-diagonal term from each chunk's
    # entry state
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, c, None, None] + z[:, :, c]
    prev = torch.stack(prev, dim=2)                           # (B,H,nc,P,N)
    y = y + torch.einsum("bcqn,bhcpn->bhcqp", cc, prev) \
        * torch.exp(seg)[..., None]
    y = y.reshape(bsz, h, nc * q, p)[:, :, :s]
    return y.to(x.dtype), state


def ssd_scan_sequential(x, dt, a, b_mat, c_mat, init_state=None):
    """The exact recurrence, one timestep at a time, in float32:
        state_t = state_{t-1} exp(dt_t a) + dt_t x_t b_t^T
        y_t     = C_t . state_t
    Same shapes as ``ssd_scan``; returns (y in x's dtype, final state)."""
    bsz, h, s, p = x.shape
    n = b_mat.shape[-1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = b_mat.float(), c_mat.float()
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, :, t] * af[None, :])         # (B, H)
        upd = (dtf[:, :, t, None, None] * xf[:, :, t, :, None]
               * bf[:, None, t, None, :])                     # (B, H, P, N)
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    y = torch.stack(ys, dim=2) if ys else xf[:, :, :0]
    return y.to(x.dtype), state
