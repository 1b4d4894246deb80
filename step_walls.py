#!/usr/bin/env python3
"""Times the qwen3_1_7b serving path and training step on one GPU.

    python3 step_walls.py [--runs N]

Builds the port's kernels, then runs chip_smoke.py's "serving path" phase
(16 requests of 32 new tokens on full-width qwen3_1_7b in bf16, 8 slots of
a 2,048-row cache) and its "training step" phase (B 2 x S 2,048, two
microbatches, remat), ``--runs`` times each in turns (default 1). Prints one
JSON line a run: the serving wall, the decode step's and the prefill's
mean ms, and the training step's wall. To compare two trees on one card,
copy this file into each and run them in one call, in turns. Exits
non-zero without a CUDA device or if a phase fails.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=1)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("step_walls: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    smoke = chip_smoke.Smoke(False)
    smoke.phase("card", smoke.card)
    smoke.phase("build", smoke.build)
    for run in range(args.runs):
        smoke.phase("serving path", smoke.serving)
        smoke.phase("training step", smoke.train_step)
        if smoke.failed:
            break
        serve, train = smoke.paths["serving"], smoke.paths["train_step"]
        print(json.dumps(dict(
            tree=str(ROOT), run=run, serving_wall_s=serve["wall_s"],
            decode_step_ms=serve["decode_step_ms"],
            prefill_ms_per_request=serve["prefill_ms_per_request"],
            train_step_wall_s=train["wall_s"],
            train_first_wall_s=train["first_wall_s"])), flush=True)
    print(smoke.smi)
    return 1 if smoke.failed else 0


if __name__ == "__main__":
    sys.exit(main())
