#!/usr/bin/env python3
"""Times the checkpoint manager's thread pool on one GPU.

    python3 ckpt_threads.py

Builds the port's kernels, runs chip_smoke.py's "training step" phase to
warm the process, then chip_smoke.py's "training loop" phase (full-width
qwen3_1_7b through ``Trainer``: 3 steps, an async save at step 2, the
blocking save at 3, a restart from step 2) four times, with
``repro_torch.ckpt.manager._IO_WORKERS`` (the threads that copy leaves to
the host, hash, write and read them) at 1, 8, 8 and 1. Prints one JSON line
a run: the phase's wall, the step walls (step 3 runs beside the step-2
write), and the seconds to snapshot, write and hash, and restore. Exits
non-zero without a CUDA device or if a phase fails.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: pool sizes in run order: the single writer thread, then the default,
#: in turns
WORKERS = (1, 8, 8, 1)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ckpt_threads: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.ckpt import manager
    smoke = chip_smoke.Smoke(False)
    smoke.phase("card", smoke.card)
    smoke.phase("build", smoke.build)
    smoke.phase("training step", smoke.train_step)
    for workers in WORKERS:
        manager._IO_WORKERS = workers
        t0 = time.perf_counter()
        smoke.phase(f"training loop, {workers} I/O threads", smoke.train_loop)
        loop = smoke.paths["train_loop"]
        print(json.dumps(dict(
            io_workers=workers, phase_s=time.perf_counter() - t0,
            **{key: loop[key] for key in (
                "step_walls_s", "resumed_step_walls_s", "snapshot_s",
                "write_s", "restore_s", "ckpt_bytes")})), flush=True)
    print(smoke.smi)
    return 1 if smoke.failed else 0


if __name__ == "__main__":
    sys.exit(main())
