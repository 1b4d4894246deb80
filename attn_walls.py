#!/usr/bin/env python3
"""Times the attention kernels at the grouped and head-dim-256 widths, and
the two serving paths they carry, on one GPU.

    python3 attn_walls.py [--float32] [--out FILE]

Builds the port's kernels, then runs chip_smoke.py's phases for them:
``flash_attention`` at gemma_2b's 8/1 x 256 (S 1,024, 1,000, 512, 128),
with the lse at S 2,048 and with a 256-token window; ``decode_attention``
at qwen2_5_32b's, grok_1_314b's, qwen2_vl_72b's and gemma_2b's widths
(groups of 5-8), then qwen3_1_7b's, granite_moe_3b_a800m's,
jamba_v0_1_52b's, granite_3_8b's and musicgen_large's (groups of 1-4; 8
slots x 2,048 rows and 1 x 32,768) and over float8 caches; each held
against its plain version and timed in turns with SDPA. Then serves
full-width gemma_2b (16 requests of 32 new tokens) and qwen2_5_32b (8 of
16) with a profiled window each. Prints one JSON line of the kernels'
rows and the serving paths' prefill ms a request, decode ms a step and
idle share, and writes everything to ``--out`` (JSON).

With ``--float32`` it times the float32 bodies instead: flash in float32
at qwen3_1_7b's 16/8 x 128 (causal at S 1,024 / 1,000 / 512 / 128 in
turns with SDPA and with the CUDA-core body, where the tree's
chip_smoke.py ``flash_vs_plain`` takes a ``label``), the lse call at S
2,048 (qwen3_1_7b's and gemma_2b's widths), the 256-token window at S 1,024 (in turns with the
causal call), ``ssd_scan`` at mamba2_1_3b's and jamba_v0_1_52b's widths in
float32 (and bfloat16), then qwen3_1_7b served with float32 params over
bfloat16 activations (a profiled window) and one training step in that
split. To compare two trees on one card, copy this file into each and run
them in one call, in turns (parent, change, change, parent). Exits non-zero
without a CUDA device or if a phase fails.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: the serving paths: (arch, depth, requests, new tokens), chip_smoke.py's
SERVED = (("gemma_2b", None, 16, 32), ("qwen2_5_32b", None, 8, 16))
#: the decode widths: groups of 5, 6, 8 and gemma_2b's 8 at head dim 256,
#: then groups of 2, 3, 4, 4 and 1
DECODE_ARCHS = ("qwen2_5_32b", "grok_1_314b", "qwen2_vl_72b", "gemma_2b",
                "qwen3_1_7b", "granite_moe_3b_a800m", "jamba_v0_1_52b",
                "granite_3_8b", "musicgen_large")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--float32", action="store_true",
                        help="time the float32 bodies and the float32-"
                             "params path instead")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attn_walls: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    smoke = chip_smoke.Smoke(False)
    smoke.phase("card", smoke.card)
    smoke.phase("build", smoke.build)
    phases = float32_phases if args.float32 else grouped_phases
    return finish(smoke, phases(smoke, chip_smoke), args.out)


def grouped_phases(smoke, chip_smoke):
    """The grouped and head-dim-256 phases (the module's docstring); returns
    the paths to report."""
    smoke.phase("flash_attention vs plain, gemma_2b",
                lambda: smoke.flash_vs_plain("gemma_2b"))
    smoke.phase("flash_attention lse vs plain", smoke.flash_lse_vs_plain)
    smoke.phase("flash_attention vs plain, sliding window",
                smoke.flash_window_vs_plain)
    for arch in DECODE_ARCHS:
        smoke.phase(f"decode_attention vs plain, {arch}",
                    lambda a=arch: smoke.decode_vs_plain(a))
    smoke.phase("decode_attention vs plain, float8 cache and window",
                smoke.decode_fp8_vs_plain)
    paths = []
    for arch, layers, requests, new_tokens in SERVED:
        path = f"serving_{arch}"
        smoke.phase(f"serving path, {arch}",
                    lambda a=arch, p=path: smoke.serving(
                        a, p, layers, requests, new_tokens))
        smoke.phase(f"serving profile, {arch}",
                    lambda p=path: smoke.serving_profile(
                        p, *chip_smoke.DENSE_PROFILE_WINDOW))
        paths.append(path)
    return paths


def float32_phases(smoke, chip_smoke):
    """The ``--float32`` phases (the module's docstring); returns the paths
    to report."""
    if "label" in inspect.signature(smoke.flash_vs_plain).parameters:
        smoke.phase("flash_attention vs plain, float32",
                    lambda: smoke.flash_vs_plain(label="float32"))
    smoke.phase("flash_attention lse vs plain", smoke.flash_lse_vs_plain)
    smoke.phase("flash_attention vs plain, sliding window",
                smoke.flash_window_vs_plain)
    smoke.phase("ssd_scan vs plain", smoke.ssd_vs_plain)
    smoke.phase("ssd_scan vs plain, jamba_v0_1_52b",
                lambda: smoke.ssd_vs_plain("jamba_v0_1_52b"))
    path = "serving_split"
    smoke.phase("serving path, float32 params over bfloat16 activations",
                lambda: smoke.serving(path=path,
                                      opts=chip_smoke.SPLIT_DTYPES))
    smoke.phase(f"serving profile, {path}",
                lambda: smoke.serving_profile(path))
    smoke.phase("training step, float32 params over bfloat16 activations",
                smoke.train_step_split)
    return [path, "train_step_split"]


#: the keys of a kernel row the JSON keeps
ROW_KEYS = ("ms", "turns_ms", "library_ms", "library_turns_ms", "plain_ms",
            "bound_ms", "bound_by", "max_abs_err", "lse_max_abs_err", "body",
            "shape", "causal_turns_ms", "cuda_core_turns_ms",
            "cuda_core_max_abs_err")
#: the keys of a path, and of its profile, the JSON keeps
PATH_KEYS = ("prefill_ms_per_request", "decode_step_ms", "wall_s",
             "decode_tc_launches", "flash_bodies")
PROFILE_KEYS = ("idle_share", "busy_ms", "wall_ms", "flash_attention",
                "decode_attention")


def finish(smoke, paths, out):
    """Prints one JSON line of the kernels' rows and ``paths``' metrics,
    writes everything to ``out``, prints the card's line; non-zero if a
    phase failed."""
    rows = {f"{name}:{key}": {k: row.get(k) for k in ROW_KEYS}
            for (name, key), row in smoke.rows.items()}
    serving = {}
    for path in paths:
        got = smoke.paths.get(path, {})
        prof = got.get("profile", {})
        serving[path] = dict(
            {key: got.get(key) for key in PATH_KEYS},
            **{f"profile_{key}": prof.get(key) for key in PROFILE_KEYS})
    print(json.dumps(dict(tree=str(ROOT), rows=rows, serving=serving)),
          flush=True)
    if out:
        out.write_text(json.dumps(dict(tree=str(ROOT), card=smoke.smi,
                                       failed=smoke.failed, rows=rows,
                                       serving=serving, paths=smoke.paths),
                                  default=str, indent=1))
    print(smoke.smi)
    return 1 if smoke.failed else 0


if __name__ == "__main__":
    sys.exit(main())
