#!/usr/bin/env python3
"""Times the attention kernels at the grouped and head-dim-256 widths, and
the two serving paths they carry, on one GPU.

    python3 attn_walls.py [--out FILE]

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
idle share, and writes everything to ``--out`` (JSON). To compare two
trees on one card, copy this file into each and run them in one call, in
turns. Exits non-zero without a CUDA device or if a phase fails.
"""
from __future__ import annotations

import argparse
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
    serving = {}
    for arch, layers, requests, new_tokens in SERVED:
        path = f"serving_{arch}"
        smoke.phase(f"serving path, {arch}",
                    lambda a=arch, p=path: smoke.serving(
                        a, p, layers, requests, new_tokens))
        smoke.phase(f"serving profile, {arch}",
                    lambda p=path: smoke.serving_profile(
                        p, *chip_smoke.DENSE_PROFILE_WINDOW))
        got = smoke.paths.get(path, {})
        prof = got.get("profile", {})
        serving[arch] = dict(
            {key: got.get(key) for key in (
                "prefill_ms_per_request", "decode_step_ms", "wall_s",
                "decode_tc_launches", "flash_bodies")},
            **{f"profile_{key}": prof.get(key) for key in (
                "idle_share", "busy_ms", "wall_ms", "flash_attention",
                "decode_attention")})
    rows = {f"{name}:{key}": {k: row.get(k) for k in (
        "ms", "turns_ms", "library_ms", "library_turns_ms", "plain_ms",
        "bound_ms", "max_abs_err", "body", "shape")}
        for (name, key), row in smoke.rows.items()}
    result = dict(tree=str(ROOT), card=smoke.smi, failed=smoke.failed,
                  rows=rows, serving=serving)
    print(json.dumps(dict(tree=str(ROOT), serving=serving)), flush=True)
    if args.out:
        args.out.write_text(json.dumps(dict(result, paths=smoke.paths),
                                       default=str, indent=1))
    print(smoke.smi)
    return 1 if smoke.failed else 0


if __name__ == "__main__":
    sys.exit(main())
