"""Top-k token-choice MoE with grouped capacity — the port of
``repro/models/moe.py``: the gather routing (``moe_impl="gather"``, the
config default) and the dense GShard one-hot baseline (``"dense"``).

Tokens are split into routing groups of up to ``MOE_GROUP`` (halved until
the group divides the token count, so a prompt is never padded before the
layer); each expert takes at most ``cap = factor * group * k / E`` of a
group's (token, choice) entries, in the stable group-local order of the
flattened entries, and drops the rest (the residual passes through). The
reference has no Pallas kernel here: the router, dispatch and combine are
plain torch and the expert products are batched matrix products
(``torch.bmm``), as the reference computes them outside any kernel.

The gather path fills each expert's buffer by gathering its entries from
the sorted ids and combines by gathering each token's k rows back and
summing over k, in float order fixed by the shapes: no scatter-add (CUDA's
float ``index_add_`` sums in atomic order) and no host read, so every shape
is static and a run's bits repeat.

On a mesh the gather path's grouping, routing, dispatch and combine run on
each device's rows (``local_map`` regions) and the expert products are
DTensor ops; the dense baseline has no sharded path of its own (no shipped
config sets it).
"""
from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .common import (act_fn, constrain_torch, dense_init, local_region_torch,
                     shard_axes_torch, unshard_dp_torch)
from .config import ModelConfig

MOE_GROUP = 256          # tokens per routing group


def _param(t):
    return torch.nn.Parameter(t, requires_grad=False)


class MoE(torch.nn.Module):
    """Params of one MoE MLP as ``init_moe`` makes them: ``router`` (D, E)
    float32 in any model; ``wi_gate``/``wi_up`` (E, D, F) for swiglu/geglu
    or ``wi`` (E, D, F) for gelu, and ``wo`` (E, F, D), in the params'
    dtype, with the reference's fan-in rule (axis 0: E for the stacks)."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device=None):
        super().__init__()
        e, d, f = cfg.moe_experts, cfg.d_model, cfg.expert_d_ff
        self.router = _param(dense_init(generator, (d, e), torch.float32,
                                        device=device))
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.wi_gate = _param(dense_init(generator, (e, d, f), dtype,
                                             device=device))
            self.wi_up = _param(dense_init(generator, (e, d, f), dtype,
                                           device=device))
        else:
            self.wi = _param(dense_init(generator, (e, d, f), dtype,
                                        device=device))
        self.wo = _param(dense_init(generator, (e, f, d), dtype,
                                    device=device))


def moe_group_plan_torch(cfg: ModelConfig, t: int):
    """(group size, groups, capacity) for ``t`` tokens, as the reference
    computes them: the group is ``min(MOE_GROUP, t)`` halved until it
    divides ``t``; the capacity the same Python float expression."""
    gsz = min(MOE_GROUP, t)
    while t % gsz:
        gsz //= 2
    cap = max(int(cfg.moe_capacity_factor * gsz * cfg.moe_top_k
                  / cfg.moe_experts), 1)
    return gsz, t // gsz, cap


def _route_torch(cfg: ModelConfig, p: MoE, xt, expert_idx=None):
    """Router over groups xt (G, T, D): float32 logits and softmax, the
    top k (descending; ties to the lower expert, as ``lax.top_k``), gates
    renormalised by max(sum, 1e-9), and the load-balancing aux loss.
    ``expert_idx`` (G, T, k), when given, replaces the top k (the gates are
    then the probabilities there): a comparison can force one run's
    routing on another. Returns (gate_vals, expert_idx, aux)."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    if expert_idx is None:
        vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, expert_idx = vals[..., :k], order[..., :k]
    else:
        gate_vals = torch.gather(probs, -1, expert_idx)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
        1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return gate_vals, expert_idx, aux


def _expert_ffn_torch(cfg: ModelConfig, p: MoE, xin):
    """xin (G, E, C, D) -> (G, E, C, D): each expert's FFN over its
    buffers, one batched product an expert weight."""
    g, e, c, d = xin.shape
    xe = xin.transpose(0, 1).reshape(e, g * c, d)
    act = act_fn(cfg.mlp_type)
    if cfg.mlp_type in ("swiglu", "geglu"):
        h = act(torch.bmm(xe, unshard_dp_torch(p.wi_gate, cfg))) * torch.bmm(
            xe, unshard_dp_torch(p.wi_up, cfg))
    else:
        h = act(torch.bmm(xe, unshard_dp_torch(p.wi, cfg)))
    # (E, G*C, F), G-major: a shard holds whole groups
    h = constrain_torch(h, cfg, None, "dp", "tp", granule=(1, c, 1))
    return torch.bmm(h, unshard_dp_torch(p.wo, cfg)).reshape(
        e, g, c, d).transpose(0, 1)


def moe_apply_gather_torch(cfg: ModelConfig, p: MoE, x):
    """x (B, S, D) -> (y (B, S, D), aux): the reference's
    ``moe_apply_gather``. The stable sort of a group's flattened (token,
    choice) expert ids gives each entry its position in its expert (its
    rank among equal ids); entries at or past ``cap`` are dropped."""
    b, s, d = x.shape
    e = cfg.moe_experts
    gsz, g, cap = moe_group_plan_torch(cfg, b * s)
    if not isinstance(x, DTensor):
        xt = constrain_torch(x.reshape(g, gsz, d), cfg, "dp", None, None)
        xin, row, w, _, aux = _gather_dispatch_torch(cfg, p, cap, xt)
        yout = _expert_ffn_torch(cfg, p, xin).reshape(g, e * cap, d)
        return _gather_combine_torch(yout, row, w).reshape(b, s, d), aux
    # sharded: the grouping and the index work run on each device's rows
    # (local_map), the batch over the dp axes that divide both B and G so
    # a device holds whole groups (DTensor's own view of a batch shard as
    # groups, and its backward, come out the wrong size); the expert
    # products stay DTensor ops; the aux loss takes the router's global
    # means
    dp = shard_axes_torch(cfg, x.device_mesh, "dp", math.gcd(b, g))
    lay3, lay2 = (dp, (), ()), (dp, ())
    router = unshard_dp_torch(p.router, cfg)

    def dispatch(router, x):
        out = _gather_dispatch_torch(
            cfg, types.SimpleNamespace(router=router), cap,
            x.reshape(-1, gsz, d))
        return out[:4]

    def combine(yout, row, w):
        return _gather_combine_torch(yout, row, w).reshape(-1, s, d)
    xin, row, w, idx0 = local_region_torch(
        "moe gather dispatch", dispatch, (((), ()), lay3),
        ((dp, (), (), ()), lay2, lay3, lay2), router, x)
    probs = torch.softmax(x.float() @ router, dim=-1)        # (B, S, E)
    ce = (idx0[..., None] == torch.arange(e, device=idx0.device)).float()
    aux = e * torch.sum(probs.mean(dim=(0, 1)) * ce.mean(dim=(0, 1)))
    yout = _expert_ffn_torch(cfg, p, xin).reshape(g, e * cap, d)
    y = local_region_torch("moe gather combine", combine,
                           (lay3, lay2, lay3), (lay3,), yout, row, w)
    return y, aux


def _gather_dispatch_torch(cfg: ModelConfig, p, cap: int, xt):
    """The gather path's routing and dispatch on groups xt (G, T, D):
    (xin (G, E, cap, D), each entry's buffer row (G, T*k), its combine
    weight (G, T, k) in xt's dtype (0 where dropped), each token's first
    expert (G, T), the aux loss)."""
    g, gsz, d = xt.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    gate_vals, expert_idx, aux = _route_torch(cfg, p, xt)          # (G, T, k)
    ids = expert_idx.reshape(g, gsz * k)
    order = torch.argsort(ids, dim=1, stable=True)
    ids_sorted = torch.gather(ids, 1, order)
    experts = torch.arange(e, device=xt.device).expand(g, e).contiguous()
    start = torch.searchsorted(ids_sorted, experts, side="left")   # (G, E)
    count = torch.searchsorted(ids_sorted, experts, side="right") - start

    # buffer slot c of expert e: sorted entry start_e + c, if c < count_e
    slot = torch.arange(cap, device=xt.device)
    filled = slot < count[..., None]                               # (G, E, C)
    src = torch.where(filled, start[..., None] + slot, 0).reshape(g, e * cap)
    tok = torch.gather(torch.div(order, k, rounding_mode="floor"), 1, src)
    xin = torch.gather(xt, 1, tok[..., None].expand(g, e * cap, d))
    xin = torch.where(filled.reshape(g, e * cap, 1), xin, 0).reshape(
        g, e, cap, d)
    xin = constrain_torch(xin, cfg, "dp", None, None, None)

    # each entry's position in its expert, back in (token, choice) order
    pos_sorted = torch.arange(gsz * k, device=xt.device) - torch.gather(
        start, 1, ids_sorted)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = (pos < cap).reshape(g, gsz, k)
    row = (ids * cap + pos.clamp(max=cap - 1)).reshape(g, gsz * k)
    w = torch.where(keep, gate_vals, 0.0).to(xt.dtype)
    return xin, row, w, expert_idx[..., 0], aux


def _gather_combine_torch(yout, row, w):
    """Each token's k expert outputs gathered back from yout (G, E*cap, D)
    at ``row`` (G, T*k) and summed with weights ``w`` (G, T, k): (G, T,
    D)."""
    g, gsz, k = w.shape
    d = yout.shape[-1]
    back = torch.gather(yout, 1, row[..., None].expand(g, gsz * k, d))
    return (back.reshape(g, gsz, k, d) * w[..., None]).sum(dim=2)


def moe_apply_dense_torch(cfg: ModelConfig, p: MoE, x):
    """x (B, S, D) -> (y, aux): the GShard one-hot dispatch/combine
    baseline, ``moe_apply``'s dense path; the same drops as the gather
    path."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    gsz, g, cap = moe_group_plan_torch(cfg, b * s)
    xt = constrain_torch(x.reshape(g, gsz, d), cfg, "dp", None, None)
    gate_vals, expert_idx, aux = _route_torch(cfg, p, xt)
    flat = F.one_hot(expert_idx, e).float().reshape(g, gsz * k, e)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = (pos * flat).sum(dim=-1).int()                          # (G, T*k)
    keep = pos < cap
    # position cap (dropped) is a zero row, as jax.nn.one_hot's out-of-range
    pos_oh = F.one_hot(torch.where(keep, pos, cap).long(), cap + 1)[
        ..., :cap].float()
    disp_flat = flat[..., None] * pos_oh[..., None, :]            # (G,T*k,E,C)
    dispatch = disp_flat.reshape(g, gsz, k, e, cap).sum(dim=2)
    combine = (disp_flat * gate_vals.reshape(g, gsz * k, 1, 1)).reshape(
        g, gsz, k, e, cap).sum(dim=2)
    xin = constrain_torch(
        torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xt), cfg,
        "dp", None, None, None)
    yout = _expert_ffn_torch(cfg, p, xin)
    y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), yout)
    return y.reshape(b, s, d), aux


def moe_apply_torch(cfg: ModelConfig, p: MoE, x):
    """x (B, S, D) -> (y (B, S, D), aux scalar float32), by
    ``cfg.moe_impl`` as the reference's ``moe_apply``: "gather", else the
    dense baseline."""
    if cfg.moe_impl == "gather":
        return moe_apply_gather_torch(cfg, p, x)
    return moe_apply_dense_torch(cfg, p, x)
