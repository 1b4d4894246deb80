"""Roofline analysis of dry-run artifacts for an NVIDIA H100 SXM: the port
of ``repro/launch/roofline.py`` (whose constants are a TPU v5e's).

Three terms per (arch x shape x mesh), in seconds per step and per device:

  compute    = FLOPs / 989 TFLOP/s            (dense bf16 tensor cores)
  memory     = bytes accessed / 3.35 TB/s     (HBM3)
  collective = wire bytes of groups inside one 8-GPU node / 450 GB/s
               (NVLink 4, per direction)
             + wire bytes of groups that span nodes / 50 GB/s
               (one 400 Gb/s NDR InfiniBand adapter a GPU)

The figures are NVIDIA's H100 SXM5 data sheet (dense, without sparsity)
and its DGX H100 reference design (eight GPUs on NVLink 4 a node, one
ConnectX-7 NDR port a GPU); the H100's counterparts of the reference's
ICI/DCN pair (``roofline.py:25-26``). A ring over a group that spans nodes
runs at the network's rate, so its whole wire volume takes the network
term: a 16-way "model" axis spans two nodes, a "data" axis of stride 16
sixteen. FLOPs, bytes and wire bytes come from ``launch/dryrun.py``: what
one device's eager program runs, each op's inputs read and outputs
written once, and each kernel call at its own inputs, outputs and FLOPs
(``launch/collectives.py``, with the ring factors). So the largest term
is a floor on the step's time that the eager program cannot beat short
of reuse through the L2 cache. The dominant term is the bottleneck;
roofline fraction = compute / max(all three).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

PEAK_FLOPS = 989e12          # bf16 dense / GPU (H100 SXM5 data sheet)
HBM_BW = 3.35e12             # bytes/s / GPU (HBM3)
NVLINK_BW = 450e9            # bytes/s / GPU / direction (NVLink 4)
NETWORK_BW = 50e9            # bytes/s / GPU (400 Gb/s NDR InfiniBand)


def analyze_artifact_np(art: dict) -> dict:
    """The three terms, the bottleneck and the derived shares of one
    dry-run result (``lower_cell_torch``'s dict)."""
    ca = art["cost_analysis"]
    flops = ca.get("flops", 0.0)
    byts = ca.get("bytes accessed", 0.0)
    wire = sum(c.get("wire_bytes", 0.0) for c in art["collectives"].values())
    wire_net = sum(c.get("wire_bytes_internode", 0.0)
                   for c in art["collectives"].values())
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = (wire - wire_net) / NVLINK_BW + wire_net / NETWORK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    model_flops = art["model_flops"]
    traced_global = flops * art["devices"]
    model_flops_rate = (model_flops / bound / art["devices"]
                        if bound > 0 else 0.0)
    mem = art["memory_analysis"]
    return {
        "arch": art["arch"], "shape": art["shape"], "mesh": art["mesh"],
        "kind": art["kind"], "devices": art["devices"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "bound_s": bound, "model_flops": model_flops,
        "traced_flops_global": traced_global,
        "useful_ratio": (model_flops / traced_global
                         if traced_global else 0.0),
        "roofline_fraction": compute_s / bound if bound > 0 else 0.0,
        "mfu_at_roofline": model_flops_rate / PEAK_FLOPS,
        "hbm_gb_per_dev": (mem["argument_size_in_bytes"]
                           + mem["temp_size_in_bytes"]
                           + mem["output_size_in_bytes"]) / 1e9,
        "wire_gb_per_dev": wire / 1e9,
        "wire_gb_internode_per_dev": wire_net / 1e9,
        "trace_s": art.get("trace_s"),
    }


def load_all_np(directory: str, mesh: str | None = None, tag: str = ""):
    rows = []
    for path in sorted(Path(directory).glob(f"*{tag}.json")):
        art = json.loads(path.read_text())
        if not art.get("ok") or art.get("skipped"):
            continue
        if mesh and art.get("mesh") != mesh:
            continue
        rows.append(analyze_artifact_np(art))
    return rows


def suggestion_np(row: dict) -> str:
    if row["dominant"] == "collective":
        return ("collective-bound: keep tensor-parallel groups inside a "
                "node (NVLink), overlap the FSDP gathers with compute, or "
                "shard the sequence instead of all-reducing activations")
    if row["dominant"] == "memory":
        if row["kind"] == "decode":
            return ("KV-cache traffic bound: quantize KV to int8/fp8 or "
                    "shrink the per-step working set")
        return ("activation traffic bound: fuse (the eager plain versions "
                "move every intermediate), microbatch, bf16 scores")
    return "tensor-core bound: raise per-GPU batch or cut the recompute"


def format_table_np(rows) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':6s} "
           f"{'compute_s':>10s} {'memory_s':>10s} {'collect_s':>10s} "
           f"{'bound':>10s} {'roofline%':>9s} {'useful%':>8s} {'HBM_GB':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
            f"{r['compute_s']:10.3e} {r['memory_s']:10.3e} "
            f"{r['collective_s']:10.3e} {r['dominant']:>10s} "
            f"{100 * r['roofline_fraction']:8.1f}% "
            f"{100 * r['useful_ratio']:7.1f}% {r['hbm_gb_per_dev']:7.1f}")
    return "\n".join(lines)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="H100 roofline of dry-run "
                                             "artifacts")
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = load_all_np(args.dir, args.mesh, args.tag)
    print(format_table_np(rows))
    print("\nper-cell bottleneck guidance:")
    for r in rows:
        print(f"  {r['arch']:>24s}/{r['shape']:<12s}: [{r['dominant']}] "
              f"{suggestion_np(r)}")
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
