"""Abstract inputs for every (arch x shape) cell: the port of
``repro/launch/specs.py``. Each function returns empty tensors of the
reference's shapes and dtypes on ``device`` (meta by default: no storage;
the dry run passes "cpu" under a ``FakeTensorMode``), keyed as the
reference keys its ``ShapeDtypeStruct``s. Token ids are int32, as the
reference's; the port's entry points take any integer dtype.
"""
from __future__ import annotations

import torch

from ..configs import ShapeSpec
from ..models.common import dtype_of
from ..models.config import ModelConfig
from ..models.model import abstract_caches_torch


def batch_inputs_torch(cfg: ModelConfig, batch: int, seq: int, kind: str,
                       device="meta") -> dict:
    """tokens (B, S) int32; labels (train); M-RoPE positions (3, B, S)
    int32; the frontend stub's extra_embeds (B, S, D) in the compute dtype
    and bool extra_mask (B, S)."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    specs = {"tokens": empty((batch, seq), torch.int32)}
    if kind == "train":
        specs["labels"] = empty((batch, seq), torch.int32)
    if cfg.rope_type == "mrope":
        specs["positions"] = empty((3, batch, seq), torch.int32)
    if cfg.frontend != "none":
        specs["extra_embeds"] = empty((batch, seq, cfg.d_model),
                                      dtype_of(cfg.dtype))
        specs["extra_mask"] = empty((batch, seq), torch.bool)
    return specs


def decode_inputs_torch(cfg: ModelConfig, batch: int, max_len: int,
                        device="meta"):
    """(caches, token (B,) int32, pos () int32) of one decode step."""
    caches = abstract_caches_torch(cfg, batch, max_len, device)
    token = torch.empty((batch,), dtype=torch.int32, device=device)
    pos = torch.empty((), dtype=torch.int32, device=device)
    return caches, token, pos


def input_specs_torch(cfg: ModelConfig, shape: ShapeSpec,
                      device="meta") -> dict:
    """All abstract inputs of the cell's step (params and state apart):
    {"batch"} for train and prefill, {"caches", "token", "pos"} for
    decode."""
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_inputs_torch(cfg, shape.global_batch,
                                            shape.seq_len, shape.kind,
                                            device)}
    if shape.kind == "decode":
        caches, token, pos = decode_inputs_torch(cfg, shape.global_batch,
                                                 shape.seq_len, device)
        return {"caches": caches, "token": token, "pos": pos}
    raise ValueError(shape.kind)
