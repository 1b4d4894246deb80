#!/usr/bin/env python3
"""Holds chip_smoke.py's raw-event reading of a serving profile against
``key_averages()`` on one GPU.

    python3 profile_check.py

Builds the port's kernels, then runs chip_smoke.py's "serving path" and
"serving profile" phases for full-width qwen3_1_7b and granite_moe_3b_a800m
(its MoE layers run inside a ``moe_layer`` range). Each profile is read
twice: by ``chip_smoke.profiled_device_times`` (the phase's own reading),
then by the profiler's ``key_averages()``. Prints one JSON line a profile:
both readings' seconds, and whether the kernel rows (names, counts, device
us), the busy time and the MoE range's device time agree. Exits non-zero
without a CUDA device, if a phase fails, or if the two readings differ.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: (arch, the phase's path name) of each profiled serving window
MODELS = (("qwen3_1_7b", "serving"),
          ("granite_moe_3b_a800m", "serving_granite_moe_3b_a800m"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_check: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from torch.autograd import DeviceType
    raw = chip_smoke.profiled_device_times
    agree = []

    def both(prof, range_name):
        t0 = time.perf_counter()
        rows, range_us = raw(prof, range_name)
        t1 = time.perf_counter()
        events = prof.key_averages()
        t2 = time.perf_counter()
        old = {e.key: [float(e.self_device_time_total), e.count]
               for e in events if e.device_type == DeviceType.CUDA
               and e.key != range_name}
        old_range = sum(float(e.device_time_total) for e in events
                        if e.key == range_name
                        and e.device_type == DeviceType.CPU)
        same = rows == old and range_us == old_range
        agree.append(same)
        print(json.dumps(dict(
            raw_s=t1 - t0, key_averages_s=t2 - t1, kernels=len(old),
            rows_equal=rows == old,
            busy_us=[sum(v[0] for v in rows.values()),
                     sum(v[0] for v in old.values())],
            range_us=[range_us, old_range], equal=same)), flush=True)
        return rows, range_us

    chip_smoke.profiled_device_times = both
    smoke = chip_smoke.Smoke(False)
    smoke.phase("card", smoke.card)
    smoke.phase("build", smoke.build)
    for arch, path in MODELS:
        smoke.phase(f"serving path, {arch}",
                    lambda a=arch, p=path: smoke.serving(a, p))
        smoke.phase(f"serving profile, {arch}",
                    lambda p=path: smoke.serving_profile(p))
        smoke.free_full_model()
    print(smoke.smi)
    return 1 if smoke.failed or len(agree) != len(MODELS) \
        or not all(agree) else 0


if __name__ == "__main__":
    sys.exit(main())
