"""CLI of the port's lint: ``python -m repro_torch.analysis [--check]
[--json PATH] [--passes NAME ...] [--baseline PATH] [--root PATH]`` — the
flags and report of ``python -m repro.analysis``.

Default invocation prints the text report and always exits 0 (report
mode); ``--check`` exits 1 when any unbaselined error-severity finding
survives. It runs on the CPU and imports neither jax nor ``repro``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .runner import PASSES, run_analysis_torch, write_json_torch


def _default_root_torch() -> Path:
    """Repo root: the directory holding ``src/`` above this package."""
    return Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's contract lint: axis-threading, host-sync, "
                    "kernel-triple, observability and docstring passes.")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on unbaselined error findings "
                         "(the gate)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the machine-readable report here")
    ap.add_argument("--passes", nargs="+", metavar="NAME", default=None,
                    choices=sorted(PASSES),
                    help=f"run a subset (default: all of "
                         f"{', '.join(PASSES)})")
    ap.add_argument("--baseline", metavar="PATH", default=None,
                    help="baseline file (default: "
                         "src/repro_torch/analysis/baseline.json)")
    ap.add_argument("--root", metavar="PATH", default=None,
                    help="repo root (default: auto-detected)")
    args = ap.parse_args(argv)

    root = Path(args.root) if args.root else _default_root_torch()
    baseline = Path(args.baseline) if args.baseline else None
    report = run_analysis_torch(root, passes=args.passes,
                                baseline_path=baseline)
    print(report.render_report())
    if args.json:
        write_json_torch(report, Path(args.json))
        print(f"json report written to {args.json}")
    if args.check and report.gate_failure_count:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
