"""The train step (forward, backward, AdamW) with gradient accumulation
over microbatches: the port of ``repro/train/step.py``'s
``make_train_state`` and ``build_train_step``.

The state is ``{"params": Transformer, "opt": optimizer state}``; the step
updates both in place and returns them. With ``microbatches`` M > 1 the
batch is split into M sequential slices on its batch dimension (M-RoPE's
(3, B, S) positions on their second), each slice's gradients are added
into float32 accumulators, and the sum is scaled by 1/M, as the
reference's ``lax.scan``; a slice's activations are freed before the next
one runs, which is what microbatching is for.
"""
from __future__ import annotations

import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.model import (Transformer, abstract_params_torch,
                            forward_train_torch)
from .optimizer import (OptimizerConfig, adamw_update_torch,
                        init_opt_state_torch)


def make_train_state_torch(cfg: ModelConfig, params: Transformer,
                           oc: OptimizerConfig, device: DeviceLike = None):
    """``{"params", "opt"}`` for ``params`` (which must live on
    ``device``, the card by default): every parameter is made trainable
    (``requires_grad_``) and gets zero moments and step 0."""
    dev = resolve_device(device)
    if params.embed.device.type != dev.type:
        raise ValueError(f"params live on {params.embed.device}, the call "
                         f"asks for {dev}")
    params.requires_grad_(True)
    return {"params": params,
            "opt": init_opt_state_torch(dict(params.named_parameters()), oc)}


def abstract_train_state_torch(cfg: ModelConfig, oc: OptimizerConfig,
                               device="meta"):
    """``make_train_state_torch``'s state for ``abstract_params_torch``'s
    model: trainable params and empty moments and step on ``device``, meta
    by default (the reference's ``abstract_train_state``)."""
    params = abstract_params_torch(cfg, device).requires_grad_(True)
    return {"params": params,
            "opt": init_opt_state_torch(dict(params.named_parameters()), oc)}


def split_batch_torch(batch: dict, microbatches: int):
    """``batch`` as ``microbatches`` dicts of consecutive slices: each leaf
    split on its batch dimension, the first, except M-RoPE positions (3,
    B, S), which lead with 3 and are split on the second (the reference's
    rule, ``step.py:47-55``). Leaves that are not tensors become tensors
    first."""
    batch = {key: x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
             for key, x in batch.items()}
    bsz = batch["tokens"].shape[0]
    if bsz % microbatches:
        raise ValueError(f"batch {bsz} does not split into {microbatches} "
                         f"microbatches")
    mb = bsz // microbatches

    def piece(x, i):
        if x.shape[0] == bsz:
            return x[i * mb:(i + 1) * mb]
        if x.ndim < 2 or x.shape[1] != bsz:
            raise ValueError(f"a batch leaf of shape {tuple(x.shape)} has "
                             f"no batch dimension of {bsz}")
        return x[:, i * mb:(i + 1) * mb]
    return [{key: piece(x, i) for key, x in batch.items()}
            for i in range(microbatches)]


def _backward(cfg, params, named, batch, device):
    """One forward and backward; returns (detached metrics, grads by name:
    a zero tensor where a param took no gradient)."""
    for p in named.values():
        p.grad = None
    loss, metrics = forward_train_torch(cfg, params, batch, device)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in named.items()}
    for p in named.values():
        p.grad = None
    return {k: v.detach() for k, v in metrics.items()}, grads


def build_train_step_torch(cfg: ModelConfig, oc: OptimizerConfig,
                           microbatches: int = 1, device: DeviceLike = None):
    """(state, batch) -> (state, metrics), the reference's
    ``build_train_step``. ``batch`` as ``forward_train_torch`` takes it.
    Metrics: ``loss``, ``nll`` and ``aux_loss`` (with microbatches, their
    means over the slices; the reference keeps only ``loss`` then), ``lr``
    and ``grad_norm`` (before clipping), float32 scalar tensors."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1: {microbatches}")

    def train_step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        if microbatches == 1:
            metrics, grads = _backward(cfg, params, named, batch, device)
        else:
            grads, sums = None, None
            for piece in split_batch_torch(batch, microbatches):
                m, g = _backward(cfg, params, named, piece, device)
                if grads is None:
                    grads = {n: t.float() for n, t in g.items()}
                    sums = dict(m)
                else:
                    for n, t in g.items():
                        grads[n].add_(t)
                    sums = {k: sums[k] + v for k, v in m.items()}
                del g
            inv = 1.0 / microbatches
            for t in grads.values():
                t.mul_(inv)
            metrics = {k: v * inv for k, v in sums.items()}
        opt, opt_metrics = adamw_update_torch(named, grads, state["opt"], oc)
        metrics.update(opt_metrics)
        return {"params": params, "opt": opt}, metrics

    return train_step
