"""Sharding rules: logical tensor axes -> mesh axes, the port of
``repro/launch/sharding.py``, and their DTensor placements.

The rules are the reference's, unchanged (``ShardingOptions`` and its five
levers, ``param_specs``, ``batch_specs``, ``cache_specs``, ``token_specs``,
``opt_state_specs``, ``sanitize_specs``' longest-divisible-prefix rule),
each under a name of its own (``_np``: they compute on names and shapes):

  params   : "wide" dim (vocab / d_ff / heads*head_dim / d_inner /
             expert-ff) over "model" (TP), d_model over the data-parallel
             axes (FSDP / ZeRO-3).
  batch    : over dp axes; sequence unsharded.
  KV cache : batch over dp, sequence over "model" (split-KV) when batch >=
             ``shard_cache_seq_threshold``, else sequence over the whole
             mesh.
  SSM state: heads over "model"; headdim over "data" for batch-1.

A spec is the port's own small type, ``Spec``: a tuple with one entry a
tensor dim, each None, a mesh-axis name or a tuple of them. Param specs are
keyed by ``Transformer.state_dict()`` names (``layers.<g * width +
slot>.<name>``, as ``models/convert.py`` maps the reference's leaves), with
the reference's leading ``groups`` axis dropped; cache specs are a list
with one dict a layer, as ``models.model.init_caches`` builds the caches.

``placements_torch`` turns a spec into DTensor placements: a tensor dim
over ("pod", "data") becomes ``Shard(d)`` on both mesh dims, which DTensor
splits in mesh order, pod-major, the layout of jax's ``P(("pod",
"data"))``. ``distribute_state_torch`` shards a ``Transformer`` (its
parameters become DTensors), its AdamW state and its caches.

A ``mesh`` here is a ``DeviceMesh`` or a ``MeshAxes`` (names and sizes
only): the specs and per-device shapes need no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from ..models.config import ModelConfig


class Spec(tuple):
    """One tensor's spec: an entry a dim, None, an axis name or a tuple of
    axis names (jax's ``PartitionSpec`` as a tuple)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """A mesh's axis names and sizes, without devices or a process group;
    it answers what ``DeviceMesh`` answers here."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, mesh_dim: int | None = None) -> int:
        return (math.prod(self.shape) if mesh_dim is None
                else self.shape[mesh_dim])


def production_axes_np(multi_pod: bool = False) -> MeshAxes:
    """The production mesh's ``MeshAxes`` (``launch/mesh.py``)."""
    from .mesh import PRODUCTION_SHAPES
    shape, names = PRODUCTION_SHAPES[multi_pod]
    return MeshAxes(shape, names)


def axis_sizes_np(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or ``MeshAxes``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    """Hillclimb levers (defaults = baseline)."""
    seq_shard_prefill: bool = False     # shard sequence over 'model' in prefill
    fsdp_params: bool = True            # d_model dim of params over dp
    shard_cache_seq_threshold: int = 16 # batch < threshold -> shard cache seq
    expert_parallel: bool = False       # experts over 'model' instead of ff
    decode_cache_shard: str = "seq"     # seq (split-KV) | headdim


def _dp_np(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _slot_specs_np(cfg: ModelConfig, mesh, opts: ShardingOptions) -> list:
    """{leaf name: Spec} for each slot of ``cfg.block_pattern``: the
    reference's ``groups`` subtree with its leading None dropped."""
    dpa = _dp_np(mesh) if opts.fsdp_params else None
    g = Spec
    attn = {"wq": g(dpa, "model"), "wk": g(dpa, "model"),
            "wv": g(dpa, "model"), "wo": g("model", dpa)}
    if cfg.qkv_bias:
        attn.update({"bq": g("model"), "bk": g("model"), "bv": g("model")})
    if cfg.qk_norm:
        attn.update({"q_norm.scale": g(None), "k_norm.scale": g(None)})
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp = {"wi_gate": g(dpa, "model"), "wi_up": g(dpa, "model"),
               "wo": g("model", dpa)}
    else:
        mlp = {"wi": g(dpa, "model"), "wo": g("model", dpa)}
    if opts.expert_parallel:
        moe = {"router": g(dpa, None),
               "wi_gate": g("model", dpa, None), "wi_up": g("model", dpa, None),
               "wi": g("model", dpa, None), "wo": g("model", None, dpa)}
    else:
        moe = {"router": g(dpa, None),
               "wi_gate": g(None, dpa, "model"), "wi_up": g(None, dpa, "model"),
               "wi": g(None, dpa, "model"), "wo": g(None, "model", dpa)}
    if cfg.mlp_type not in ("swiglu", "geglu"):
        moe.pop("wi_gate"), moe.pop("wi_up")
    else:
        moe.pop("wi")
    mamba = {"in_proj": g(dpa, "model"), "conv_w": g(None, "model"),
             "conv_b": g("model"), "A_log": g(None), "D": g(None),
             "dt_bias": g(None), "out_proj": g("model", dpa)}
    slots = []
    for mixer, mlp_kind in cfg.block_pattern:
        blk = {"norm_mixer.scale": g(None)}
        mix = attn if mixer == "attn" else mamba
        blk.update({f"{'attn' if mixer == 'attn' else 'mamba'}.{k}": v
                    for k, v in mix.items()})
        if mlp_kind != "none":
            blk["norm_mlp.scale"] = g(None)
            sub = mlp if mlp_kind == "dense" else moe
            blk.update({f"{'mlp' if mlp_kind == 'dense' else 'moe'}.{k}": v
                        for k, v in sub.items()})
        slots.append(blk)
    return slots


def param_specs_np(cfg: ModelConfig, mesh,
                   opts: ShardingOptions = ShardingOptions()) -> dict:
    """{state-dict name: Spec} for a ``Transformer`` of ``cfg``."""
    dpa = _dp_np(mesh) if opts.fsdp_params else None
    specs = {"embed": Spec("model", dpa), "final_norm.scale": Spec(None)}
    slots = _slot_specs_np(cfg, mesh, opts)
    width = len(cfg.block_pattern)
    for i in range(cfg.num_layers):
        for name, spec in slots[i % width].items():
            specs[f"layers.{i}.{name}"] = spec
    if not cfg.tie_embeddings:
        specs["unembed"] = Spec(dpa, "model")
    return specs


def batch_specs_np(cfg: ModelConfig, mesh, kind: str,
                   opts: ShardingOptions = ShardingOptions()) -> dict:
    """Specs for the input batch of each step kind (train, prefill)."""
    dpa = _dp_np(mesh)
    seq_axis = "model" if (opts.seq_shard_prefill and kind == "prefill") else None
    tok = Spec(dpa, seq_axis)   # (B, S)
    if kind in ("train", "prefill"):
        specs = {"tokens": tok, "labels": tok}
        if cfg.rope_type == "mrope":
            specs["positions"] = Spec(None, dpa, None)
        if cfg.frontend != "none":
            specs["extra_embeds"] = Spec(dpa, None, None)
            specs["extra_mask"] = Spec(dpa, None)
        if kind == "prefill":
            specs.pop("labels")
        return specs
    raise ValueError(kind)


def cache_specs_np(cfg: ModelConfig, mesh, batch: int,
                   opts: ShardingOptions = ShardingOptions()) -> list:
    """Decode-cache specs, one dict a layer: attention (B, S, KV, hd)
    sequence-sharded over "model" (split-KV) with batch over dp, or for
    batch below the threshold sequence over the entire mesh; mamba conv
    (B, k-1, C) and ssm (B, H, P, N)."""
    dpa = _dp_np(mesh)
    big_batch = batch >= opts.shard_cache_seq_threshold
    all_axes = tuple(mesh.mesh_dim_names)
    per_slot = []
    for mixer, _ in cfg.block_pattern:
        if mixer == "attn":
            if big_batch:
                kv = (Spec(dpa, None, None, "model")
                      if opts.decode_cache_shard == "headdim"
                      else Spec(dpa, "model", None, None))
            else:
                kv = Spec(None, all_axes, None, None)
            per_slot.append({"k": kv, "v": kv})
        elif big_batch:
            per_slot.append({"conv": Spec(dpa, None, "model"),
                             "ssm": Spec(dpa, "model", None, None)})
        else:
            per_slot.append({"conv": Spec(None, None, "model"),
                             "ssm": Spec(None, "model", "data", None)})
    width = len(cfg.block_pattern)
    return [dict(per_slot[i % width]) for i in range(cfg.num_layers)]


def token_specs_np(mesh, batch: int,
                   opts: ShardingOptions = ShardingOptions()) -> Spec:
    dpa = _dp_np(mesh)
    return Spec(dpa) if batch >= opts.shard_cache_seq_threshold else Spec(None)


def opt_state_specs_np(param_spec_tree: dict) -> dict:
    """AdamW moments share the param specs; step counter replicated."""
    return {"mu": param_spec_tree, "nu": param_spec_tree, "step": Spec()}


def _axis_size_np(sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def _map_specs_np(fn, spec_tree, shape_tree):
    if isinstance(spec_tree, Spec):
        return fn(spec_tree, shape_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs_np(fn, v, shape_tree[k])
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_map_specs_np(fn, v, s)
                               for v, s in zip(spec_tree, shape_tree))
    return spec_tree


def sanitize_specs_np(spec_tree, shape_tree, mesh):
    """Drop any spec axis whose size does not divide the dim: for tuple
    axes the longest divisible prefix is kept, and every kept entry
    becomes a tuple, as the reference's ``sanitize_specs``. ``shape_tree``
    mirrors ``spec_tree`` with a tensor, or a shape, at each leaf."""
    sizes = axis_sizes_np(mesh)

    def fix(spec, leaf):
        dims = tuple(getattr(leaf, "shape", leaf))
        new = []
        for d_idx, axes in enumerate(spec):
            if d_idx >= len(dims):
                break
            if axes is None:
                new.append(None)
                continue
            cand = (axes,) if isinstance(axes, str) else tuple(axes)
            while cand and dims[d_idx] % _axis_size_np(sizes, cand) != 0:
                cand = cand[:-1]
            new.append(cand if cand else None)
        return Spec(*new)

    return _map_specs_np(fix, spec_tree, shape_tree)


def _dim_axes_np(spec: Spec, d: int) -> tuple:
    if d >= len(spec) or spec[d] is None:
        return ()
    return (spec[d],) if isinstance(spec[d], str) else tuple(spec[d])


def local_shape_np(spec: Spec, shape, mesh) -> tuple:
    """The per-device shape of a tensor of ``shape`` laid out by ``spec``
    (sanitized: every axis divides its dim)."""
    sizes = axis_sizes_np(mesh)
    out = []
    for d, n in enumerate(shape):
        k = _axis_size_np(sizes, _dim_axes_np(spec, d))
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {_dim_axes_np(spec, d)}: sanitize first")
        out.append(n // k)
    return tuple(out)


def placements_torch(spec: Spec, mesh) -> tuple:
    """DTensor placements for ``spec`` on ``mesh``: mesh dim ``i`` shards
    the tensor dim whose entry names it, else replicates. A dim over
    several mesh axes is split in mesh order (pod-major, as jax's)."""
    from ..models.common import placements_of_torch
    return placements_of_torch(mesh, tuple(_dim_axes_np(spec, d)
                                           for d in range(len(spec))))


def distribute_tensor_torch(t, spec: Spec, mesh):
    """``t`` (the same full tensor on every rank, or a fake or meta one) as
    a DTensor laid out by ``spec``: each rank keeps its chunk, and nothing
    is sent (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements_torch(spec, mesh),
                             src_data_rank=None)


def distribute_state_torch(cfg: ModelConfig, mesh, params, opt=None,
                           caches=None,
                           opts: ShardingOptions = ShardingOptions(),
                           batch: int | None = None):
    """Shard a ``Transformer`` in place by its sanitized ``param_specs_np``
    (each parameter becomes a DTensor ``Parameter`` with its
    ``requires_grad``), and return (params, opt, caches): the AdamW state
    ``{"mu", "nu", "step"}`` sharded like the params (step replicated)
    and the decode caches (``init_caches``' list) by ``cache_specs_np`` for
    ``batch`` rows (default: the caches' own), each None when not given.
    """
    import torch
    shapes = {n: p.shape for n, p in params.named_parameters()}
    pspec = sanitize_specs_np(param_specs_np(cfg, mesh, opts), shapes, mesh)
    if set(pspec) != set(shapes):
        raise ValueError(f"{cfg.name}: specs and parameters differ: "
                         f"{sorted(set(pspec) ^ set(shapes))}")
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute_tensor_torch(p.detach(), pspec[name], mesh),
            requires_grad=p.requires_grad)
    if opt is not None:
        ospec = opt_state_specs_np(pspec)
        opt = {"mu": {n: distribute_tensor_torch(t, ospec["mu"][n], mesh)
                      for n, t in opt["mu"].items()},
               "nu": {n: distribute_tensor_torch(t, ospec["nu"][n], mesh)
                      for n, t in opt["nu"].items()},
               "step": distribute_tensor_torch(opt["step"], Spec(), mesh)}
    if caches is not None:
        rows = batch if batch is not None else next(
            iter(caches[0].values())).shape[0]
        cspec = sanitize_specs_np(cache_specs_np(cfg, mesh, rows, opts),
                               caches, mesh)
        caches = [{k: distribute_tensor_torch(t, s[k], mesh)
                   for k, t in c.items()} for c, s in zip(caches, cspec)]
    return params, opt, caches
