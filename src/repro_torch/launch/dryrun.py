"""Multi-device dry run of one (arch x shape x mesh) cell: the port of
``repro/launch/dryrun.py``. It never touches a device.

``lower_cell_torch`` initialises torch's fake process group (the "fake"
backend with ``FakeStore``: every rank exists, no collective moves a byte)
with 256 or 512 ranks, builds the production mesh (``launch/mesh.py``),
builds the model and its state as fake CPU tensors under a
``FakeTensorMode`` (shapes only, no storage), shards them by the sanitized
specs of ``launch/sharding.py`` into DTensors, and runs the step once with
``launch/collectives.py``'s ``TraceRecorder`` on: train
(``build_train_step_torch`` with its microbatches and remat), prefill
(``forward_prefill``) or decode (``forward_decode``). The kernel wrappers
see CPU tensors and take their plain versions, by their own rule, each as
one operator that the recorder counts as the kernel: its inputs, outputs
and FLOP formula (a decode call reads the whole cache: the lengths are
data). The recorder counts what rank 0 runs: its FLOPs (at the local shapes, so work
DTensor replicates counts on every device), the bytes its ops read and
write (the eager program's traffic: no fusion), the collectives DTensor
inserts and the peak of the tensors the step makes. The group is
destroyed on the way out, whatever happens.

The result keeps the reference's keys where they mean the same thing:
``devices``, ``params``, ``active_params``, ``tokens_per_step``,
``model_flops``, ``cost_analysis`` (per device ``flops`` and ``bytes
accessed``), ``memory_analysis`` (per device ``argument_size_in_bytes``:
the shards of params, optimizer state, caches and inputs;
``output_size_in_bytes``: what the step returns beyond its arguments, which
it updates in place; ``temp_size_in_bytes``: the peak of the tensors the
step made, outputs included), ``collectives``, ``op_histogram``, ``ok``.
``local_regions`` lists where the step left DTensor's sharding propagation
for ``local_map`` (each kernel call, the MoE index work, the split-KV
decode), with their call counts.

Not copied: the reference's G=1/G=2 extrapolation (``dryrun.py:167-201``)
and its flash-jnp trip correction (``:203-237``) make up for XLA's cost
analysis counting a ``while`` body once; this trace unrolls every layer,
microbatch and kv block, so each op is counted as often as it runs.

The trace runs under ``collectives.quiet_dtensor_bookkeeping_torch``:
DTensor's sharding propagation and its strided-shard offsets build small
index tensors and read them back, which a ``FakeTensorMode`` forbids, so
they run with the fake mode unset, and unrecorded.

CLI: ``python -m repro_torch.launch.dryrun --arch qwen3_1_7b --shape
decode_32k`` writes ``artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json``;
``python -m repro_torch.launch.roofline`` reads the folder. Beyond the
reference's flags, ``--mesh-shape 1x1`` traces one device (a one-rank
group), ``--batch``/``--seq`` replace the shape's sizes and ``--smoke``
takes the smoke config.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import time
import traceback
from pathlib import Path

from ..configs import (ARCH_IDS, SHAPES, ShapeSpec, get_config,
                       get_smoke_config, shape_applicable_np)
from . import sharding as sh
from .collectives import (TraceRecorder, op_histogram_torch,
                          quiet_dtensor_bookkeeping_torch)


def _mesh_name_np(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


@contextlib.contextmanager
def fake_process_group_torch(world_size: int):
    """torch's fake process group of ``world_size`` ranks as the default
    group (this process is rank 0), destroyed on exit. Refuses to run over
    an existing default group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists; the dry run "
                           "makes its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_torch(multi_pod: bool, mesh_shape):
    """The production mesh, or a ("data", "model") / ("pod", "data",
    "model") mesh of ``mesh_shape`` over the default group."""
    from .mesh import make_production_mesh_torch
    if mesh_shape is None:
        return make_production_mesh_torch(multi_pod)
    from torch.distributed.device_mesh import init_device_mesh
    names = ("data", "model") if len(mesh_shape) == 2 else (
        "pod", "data", "model")
    return init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=names)


def _local_bytes_torch(tree) -> int:
    """Bytes of the local shards (or tensors) of ``tree``."""
    from torch.distributed.tensor import DTensor
    from .collectives import _tensors_torch
    total = 0
    for t in _tensors_torch(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _distribute_inputs_torch(inputs: dict, specs: dict, mesh) -> dict:
    specs = sh.sanitize_specs_np(specs, inputs, mesh)
    return {k: sh.distribute_tensor_torch(v, specs[k], mesh)
            for k, v in inputs.items()}


def _step_torch(cfg, shape: ShapeSpec, mesh, opts, microbatches: int):
    """The sharded abstract state and inputs of one cell's step (fake CPU
    tensors: call under a ``FakeTensorMode``), as (its arguments, a
    function running the step and returning its outputs)."""
    from ..models.model import (abstract_params_torch, forward_decode,
                                forward_prefill)
    from ..train.optimizer import OptimizerConfig
    from ..train.step import (abstract_train_state_torch,
                              build_train_step_torch)
    from .specs import input_specs_torch
    inputs = input_specs_torch(cfg, shape, "cpu")
    if shape.kind == "train":
        oc = OptimizerConfig(state_dtype=cfg.opt_state_dtype)
        state = abstract_train_state_torch(cfg, oc, "cpu")
        params, opt, _ = sh.distribute_state_torch(
            cfg, mesh, state["params"], state["opt"], opts=opts)
        batch = _distribute_inputs_torch(
            inputs["batch"], sh.batch_specs_np(cfg, mesh, "train", opts),
            mesh)
        step = build_train_step_torch(cfg, oc, microbatches, device="cpu")
        return ([list(params.parameters()), opt, batch],
                lambda: step({"params": params, "opt": opt}, batch)[1])
    if shape.kind == "prefill":
        params, _, _ = sh.distribute_state_torch(
            cfg, mesh, abstract_params_torch(cfg, "cpu"), opts=opts)
        batch = _distribute_inputs_torch(
            inputs["batch"], sh.batch_specs_np(cfg, mesh, "prefill", opts),
            mesh)
        return ([list(params.parameters()), batch],
                lambda: forward_prefill(
                    cfg, params, batch["tokens"], batch.get("positions"),
                    batch.get("extra_embeds"), batch.get("extra_mask"),
                    device="cpu"))
    params, _, caches = sh.distribute_state_torch(
        cfg, mesh, abstract_params_torch(cfg, "cpu"),
        caches=inputs["caches"], opts=opts, batch=shape.global_batch)
    tspec = sh.sanitize_specs_np(
        sh.token_specs_np(mesh, shape.global_batch, opts), inputs["token"],
        mesh)
    token = sh.distribute_tensor_torch(inputs["token"], tspec, mesh)
    pos = inputs["pos"]
    return ([list(params.parameters()), caches, token, pos],
            lambda: forward_decode(cfg, params, caches, token, pos,
                                   device="cpu")[0])


def lower_cell_torch(arch: str, shape_name: str, multi_pod: bool = False,
                     opts: sh.ShardingOptions = sh.ShardingOptions(),
                     microbatches: int = 1, cfg_overrides: dict | None = None,
                     *, mesh_shape=None, shape: ShapeSpec | None = None,
                     smoke: bool = False) -> dict:
    """Trace one cell's step on a fake group and return its analysis
    (module docstring). ``mesh_shape`` replaces the production mesh (the
    group then has that many ranks), ``shape`` the cell's ``SHAPES``
    entry, and ``smoke`` takes the arch's smoke config."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    shape = shape or SHAPES[shape_name]
    devices = (math.prod(mesh_shape) if mesh_shape is not None
               else 512 if multi_pod else 256)
    three_axes = multi_pod or (mesh_shape is not None
                               and len(mesh_shape) == 3)
    dpa = ("pod", "data") if three_axes else ("data",)
    small_batch = (shape.kind == "decode"
                   and shape.global_batch < opts.shard_cache_seq_threshold)
    act_axes = {"dp_axes": () if small_batch else dpa, "tp_axis": "model"}
    act_axes.update(cfg_overrides or {})
    cfg = (get_smoke_config if smoke else get_config)(arch, **act_axes)
    t0 = time.time()
    with fake_process_group_torch(devices), \
            quiet_dtensor_bookkeeping_torch():
        mesh = _mesh_torch(multi_pod, mesh_shape)   # before the fake mode
        with FakeTensorMode():
            args, run = _step_torch(cfg, shape, mesh, opts, microbatches)
            rec = TraceRecorder()
            rec.hold_arguments_torch(args)
            arg_bytes = _local_bytes_torch(args)
            with implicit_replication(), rec:
                out_bytes = _local_bytes_torch(run())
        trace_s = time.time() - t0
        mesh_axes = {"shape": list(mesh.shape),
                     "axes": list(mesh.mesh_dim_names)}
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    result = {
        "arch": arch, "shape": shape.name,
        "mesh": (_mesh_name_np(multi_pod) if mesh_shape is None
                 else "x".join(map(str, mesh_shape))),
        "mesh_shape": mesh_axes, "kind": shape.kind, "devices": devices,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "config": cfg.name, "layers": cfg.num_layers,
        "params": int(n_params), "active_params": int(n_active),
        "tokens_per_step": int(tokens), "model_flops": float(model_flops),
        "cost_analysis": {"flops": float(rec.flops),
                          "bytes accessed": float(rec.bytes_accessed)},
        "memory_analysis": {"argument_size_in_bytes": int(arg_bytes),
                            "output_size_in_bytes": int(out_bytes),
                            "temp_size_in_bytes": int(rec.temp_peak)},
        "collectives": rec.collective_summary(),
        "op_histogram": op_histogram_torch(rec),
        "local_regions": dict(rec.regions),
        "trace_s": round(trace_s, 2),
        "sharding_options": dataclasses.asdict(opts),
        "cfg_overrides": cfg_overrides or {},
        "microbatches": microbatches,
        "ok": True,
    }
    gc.collect()
    return result


def _parse_value_np(v: str):
    if v.lstrip("-").isdigit():
        return int(v)
    if v in ("True", "False", "true", "false"):
        return v in ("True", "true")
    return v


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="multi-device dry run (fake "
                                             "process group, no device)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="sweep every applicable (arch x shape) cell")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt", action="append", default=[],
                    help="ShardingOptions override, e.g. --opt fsdp_params=0")
    ap.add_argument("--cfg", action="append", default=[],
                    help="ModelConfig override, e.g. --cfg num_layers=8")
    ap.add_argument("--tag", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (a quick rehearsal)")
    ap.add_argument("--mesh-shape", default=None,
                    help="a (data, model) or (pod, data, model) mesh of a "
                         "fake group of that many ranks in place of the "
                         "production mesh, e.g. 1x1 for one device")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (decode: cache rows) in place of "
                         "the shape's")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(n) for n in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)

    overrides = {}
    field_types = {f.name: f.type for f in
                   dataclasses.fields(sh.ShardingOptions)}
    for kv in args.opt:
        k, v = kv.split("=")
        if field_types[k] in ("bool", bool):
            overrides[k] = v in ("1", "true", "True")
        elif field_types[k] in ("int", int):
            overrides[k] = int(v)
        else:
            overrides[k] = v
    opts = sh.ShardingOptions(**overrides)
    cfg_overrides = {}
    for kv in args.cfg:
        k, v = kv.split("=")
        cfg_overrides[k] = _parse_value_np(v)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in meshes]
    else:
        cells = [(args.arch, args.shape, m) for m in meshes]

    results = []
    for arch, shape_name, m in cells:
        tag = f"_{args.tag}" if args.tag else ""
        if mesh_shape is not None:
            m = args.mesh_shape
        path = outdir / f"{arch}_{shape_name}_{m}{tag}.json"
        if path.exists() and not args.force:
            print(f"[skip] {path.name} exists")
            continue
        if not shape_applicable_np(arch, shape_name):
            path.write_text(json.dumps({
                "arch": arch, "shape": shape_name, "mesh": m, "ok": True,
                "skipped": "full-attention arch: long_500k needs "
                           "sub-quadratic attention"}))
            print(f"[skip-cell] {arch} {shape_name} (full attention)")
            continue
        print(f"[trace] {arch} {shape_name} {m} ...", flush=True)
        t0 = time.time()
        try:
            shape = SHAPES[shape_name]
            shape = dataclasses.replace(
                shape, global_batch=args.batch or shape.global_batch,
                seq_len=args.seq or shape.seq_len)
            res = lower_cell_torch(arch, shape_name, m == "multi", opts,
                                   args.microbatches, cfg_overrides,
                                   mesh_shape=mesh_shape, shape=shape,
                                   smoke=args.smoke)
            path.write_text(json.dumps(res, indent=1))
            ca, ma = res["cost_analysis"], res["memory_analysis"]
            print(f"[ok] {path.name}: flops/dev={ca['flops']:.3e} "
                  f"args/dev={ma['argument_size_in_bytes'] / 1e9:.3f} GB "
                  f"temp/dev={ma['temp_size_in_bytes'] / 1e9:.3f} GB "
                  f"total={time.time() - t0:.0f}s", flush=True)
        except Exception as exc:  # noqa: BLE001 — a sweep survives a cell
            res = {"arch": arch, "shape": shape_name, "mesh": m, "ok": False,
                   "error": f"{type(exc).__name__}: {exc}",
                   "traceback": traceback.format_exc()[-4000:]}
            path.write_text(json.dumps(res))
            print(f"[FAIL] {arch} {shape_name} {m}: {exc}", flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
