"""The port's sharding rules and abstract inputs (``repro_torch.launch.
sharding``, ``launch.specs``) against the reference's
(``repro.launch.sharding``, ``launch.specs``) at production size, with no
devices: the reference side lays its specs on a
``jax.sharding.AbstractMesh`` of (16, 16) ("data", "model") or (2, 16, 16)
("pod", "data", "model"), the port's on a ``MeshAxes`` of the same names
and sizes.

For every arch of ``ARCH_IDS`` on both meshes: each sanitized param spec
equals the reference's for the same leaf (its leading ``groups`` entry
dropped), and the per-device bytes of params and AdamW state equal the sum
of ``NamedSharding(mesh, spec).shard_shape(...)`` over the reference's
leaves. The same for ``batch_specs``, ``cache_specs`` and ``token_specs``
over the four shapes, and for each ``ShardingOptions`` lever alone. Then
``input_specs_torch`` against the reference's ``input_specs`` for every
applicable cell, caches layer by layer against the reference's (G, ...)
stacks, and ``placements_torch`` on a fake 256-rank group."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro.launch import sharding as rs
from repro.launch.specs import input_specs
from repro.models import abstract_caches, abstract_params
from repro.train.optimizer import OptimizerConfig
from repro.train.step import abstract_train_state
from repro_torch import configs as tconfigs
from repro_torch.launch import sharding as ts
from repro_torch.launch.specs import input_specs_torch
from repro_torch.models.model import abstract_caches_torch
from repro_torch.train import optimizer as topt
from repro_torch.train.step import abstract_train_state_torch

MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
LEVERS = [ts.ShardingOptions(seq_shard_prefill=True),
          ts.ShardingOptions(fsdp_params=False),
          ts.ShardingOptions(shard_cache_seq_threshold=256),
          ts.ShardingOptions(expert_parallel=True),
          ts.ShardingOptions(decode_cache_shard="headdim")]


def _norm(spec):
    """A spec as a tuple of axis tuples, trailing Nones dropped."""
    out = [None if a is None else ((a,) if isinstance(a, str) else tuple(a))
           for a in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_opts(opts):
    return rs.ShardingOptions(**dataclasses.asdict(opts))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _by_port_name(cfg, tree):
    """The reference's params-shaped tree as {port state-dict name: (leaf,
    grouped)}: group leaves under each layer's name, once a slot."""
    width = len(cfg.block_pattern)
    out = {}
    for name, leaf in _flat({k: v for k, v in tree.items()
                             if k != "groups"}):
        out[name] = (leaf, False)
    for name, leaf in _flat(tree["groups"]):
        slot, rest = name.split(".", 1)
        for g in range(cfg.groups):
            out[f"layers.{g * width + int(slot)}.{rest}"] = (leaf, True)
    return out


@pytest.fixture(scope="module")
def abstract():
    """Per arch: the reference's abstract params and train state, the
    port's meta train state."""
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        oc = OptimizerConfig(state_dtype=cfg.opt_state_dtype)
        tcfg = tconfigs.get_config(arch)
        t_state = abstract_train_state_torch(
            tcfg, topt.OptimizerConfig(state_dtype=tcfg.opt_state_dtype))
        out[arch] = (cfg, abstract_params(cfg), abstract_train_state(cfg, oc),
                     tcfg, t_state)
    return out


def _ref_bytes(mesh, spec_tree, abs_tree):
    specs = dict(_flat(spec_tree))
    total = 0
    for name, leaf in _flat(abs_tree):
        shard = NamedSharding(mesh, specs[name]).shard_shape(leaf.shape)
        total += int(np.prod(shard)) * leaf.dtype.itemsize
    return total


def _port_bytes(axes, spec_tree, tensors):
    return sum(int(np.prod(ts.local_shape_np(spec_tree[n], t.shape, axes)))
               * t.element_size() for n, t in tensors.items())


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_bytes_equal_reference(abstract, arch, multi_pod):
    cfg, params_abs, state_abs, tcfg, t_state = abstract[arch]
    mesh, axes = MESHES[multi_pod], ts.production_axes_np(multi_pod)
    ref = rs.sanitize_specs(rs.param_specs(cfg, mesh), params_abs, mesh)
    named = dict(t_state["params"].named_parameters())
    port = ts.sanitize_specs_np(ts.param_specs_np(tcfg, axes), named, axes)
    want = _by_port_name(cfg, ref)
    assert set(port) == set(want) == set(named)
    for name, (spec, grouped) in want.items():
        spec = tuple(spec)[1:] if grouped else tuple(spec)
        assert _norm(port[name]) == _norm(spec), name
    # per-device bytes: params, then params + AdamW moments
    assert _port_bytes(axes, port, named) == _ref_bytes(mesh, ref,
                                                        params_abs)
    ref_state = rs.sanitize_specs(
        {"params": rs.param_specs(cfg, mesh),
         "opt": rs.opt_state_specs(rs.param_specs(cfg, mesh))},
        state_abs, mesh)
    ospec = ts.opt_state_specs_np(port)
    t_bytes = (_port_bytes(axes, port, named)
               + _port_bytes(axes, ospec["mu"], t_state["opt"]["mu"])
               + _port_bytes(axes, ospec["nu"], t_state["opt"]["nu"])
               + t_state["opt"]["step"].element_size())
    r_bytes = _ref_bytes(mesh, ref_state, state_abs)
    # the reference's step counter is int32, the port's int64
    assert t_bytes - 8 == r_bytes - state_abs["opt"]["step"].dtype.itemsize


@pytest.mark.parametrize("opts", [ts.ShardingOptions()] + LEVERS,
                         ids=["baseline", "seq_shard_prefill", "no_fsdp",
                              "cache_threshold_256", "expert_parallel",
                              "headdim_cache"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
def test_input_and_cache_specs_equal_reference(abstract, opts, multi_pod):
    mesh, axes = MESHES[multi_pod], ts.production_axes_np(multi_pod)
    ropts = _ref_opts(opts)
    for arch in ARCH_IDS:
        cfg, params_abs, _, tcfg, t_state = abstract[arch]
        if opts != ts.ShardingOptions():     # the levers reach the params
            ref = rs.sanitize_specs(rs.param_specs(cfg, mesh, ropts),
                                    params_abs, mesh)
            named = dict(t_state["params"].named_parameters())
            port = ts.sanitize_specs_np(ts.param_specs_np(tcfg, axes, opts),
                                        named, axes)
            for name, (spec, grouped) in _by_port_name(cfg, ref).items():
                spec = tuple(spec)[1:] if grouped else tuple(spec)
                assert _norm(port[name]) == _norm(spec), (arch, name)
        for shape in SHAPES.values():
            if not shape_applicable(arch, shape.name):
                continue
            want_in = input_specs(cfg, shape)
            got_in = input_specs_torch(tcfg, shape)
            if shape.kind in ("train", "prefill"):
                ref = rs.sanitize_specs(
                    rs.batch_specs(cfg, mesh, shape.kind, ropts),
                    want_in["batch"], mesh)
                port = ts.sanitize_specs_np(
                    ts.batch_specs_np(tcfg, axes, shape.kind, opts),
                    got_in["batch"], axes)
                assert port.keys() == ref.keys()
                for k in ref:
                    assert _norm(port[k]) == _norm(ref[k]), (arch, k)
                continue
            b = shape.global_batch
            ref = rs.sanitize_specs(rs.cache_specs(cfg, mesh, b, ropts),
                                    want_in["caches"], mesh)
            port = ts.sanitize_specs_np(ts.cache_specs_np(tcfg, axes, b,
                                                          opts),
                                        got_in["caches"], axes)
            width = len(cfg.block_pattern)
            assert len(port) == cfg.num_layers
            for i, layer in enumerate(port):
                slot = ref[str(i % width)]
                assert layer.keys() == slot.keys()
                for k in slot:
                    assert _norm(layer[k]) == _norm(tuple(slot[k])[1:]), (
                        arch, shape.name, i, k)
            assert _norm(ts.token_specs_np(axes, b, opts)) == _norm(
                rs.token_specs(mesh, b, ropts))


def test_input_specs_equal_reference():
    to_torch = {np.dtype("int32"): torch.int32, np.dtype("bool"): torch.bool,
                np.dtype("float32"): torch.float32}
    for arch in ARCH_IDS:
        cfg, tcfg = get_config(arch), tconfigs.get_config(arch)
        for shape in SHAPES.values():
            assert tconfigs.shape_applicable_np(arch, shape.name) == \
                shape_applicable(arch, shape.name)
            if not shape_applicable(arch, shape.name):
                continue
            want, got = input_specs(cfg, shape), input_specs_torch(tcfg,
                                                                   shape)
            assert got.keys() == want.keys()
            for k in want:
                if k == "caches":
                    continue
                w, g = want[k], got[k]
                leaves = w.items() if isinstance(w, dict) else [(k, w)]
                for name, sds in leaves:
                    t = g[name] if isinstance(w, dict) else g
                    assert tuple(t.shape) == sds.shape, (arch, name)
                    dt = to_torch.get(np.dtype(sds.dtype))
                    if dt is None:     # bfloat16
                        assert t.dtype == torch.bfloat16
                    else:
                        assert t.dtype == dt, (arch, name)
                    assert t.device.type == "meta"
            if shape.kind == "decode":
                width = len(cfg.block_pattern)
                for i, layer in enumerate(got["caches"]):
                    ref = want["caches"][str(i % width)]
                    assert layer.keys() == ref.keys()
                    for n, t in layer.items():
                        assert (cfg.groups,) + tuple(t.shape) == \
                            ref[n].shape, (arch, i, n)
                        assert str(t.dtype).split(".")[-1] == \
                            str(np.dtype(ref[n].dtype)), (arch, i, n)
    cells = list(tconfigs.all_cells_np())
    assert len(cells) == 40 and sum(ok for *_, ok in cells) == 32


def test_abstract_caches_match_init_caches_layout():
    cfg = tconfigs.get_smoke_config("jamba_v0_1_52b")
    meta = abstract_caches_torch(cfg, 2, 16)
    from repro_torch.models.model import init_caches
    real = init_caches(cfg, 2, 16, device="cpu")
    for m, r in zip(meta, real):
        assert {k: (t.shape, t.dtype) for k, t in m.items()} == \
            {k: (t.shape, t.dtype) for k, t in r.items()}


def test_placements_shard_pod_major_on_a_fake_group():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.dryrun import fake_process_group_torch
    from repro_torch.launch.mesh import (dp_axes_torch,
                                         make_production_mesh_torch)
    with pytest.raises(RuntimeError, match="launch/dryrun.py"):
        make_production_mesh_torch()
    with fake_process_group_torch(512):
        mesh = make_production_mesh_torch(multi_pod=True)
        assert dp_axes_torch(mesh) == ("pod", "data")
        spec = ts.Spec(("pod", "data"), "model")
        assert ts.placements_torch(spec, mesh) == (Shard(0), Shard(0),
                                                   Shard(1))
        assert ts.placements_torch(ts.Spec(None, "model"), mesh) == (
            Replicate(), Replicate(), Shard(1))
        t = ts.distribute_tensor_torch(torch.empty(64, 32, device="meta"),
                                       spec, mesh)
        # rank 0 holds rows 0-1 (pod 0, data 0) and columns 0-1
        assert tuple(t.to_local().shape) == (2, 2)
        assert tuple(t.to_local().shape) == ts.local_shape_np(
            spec, (64, 32), ts.production_axes_np(True))
    assert not dist.is_initialized()
