"""Serving launcher: the multi-tenant engine on one card — the port of
``repro/launch/serve.py``, with ``--device`` and ``--dtype``.

Usage:
    python -m repro_torch.launch.serve --arch qwen3_1_7b --smoke --requests 12
    python -m repro_torch.launch.serve --smoke --device cpu
    python -m repro_torch.launch.serve --arch mamba2_1_3b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..configs import get_config, get_smoke_config
from ..serve import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="params and activations (default: the config's)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype,
                                  param_dtype=args.dtype)
    eng = ServingEngine(cfg, max_slots=args.slots, max_len=128,
                        tenant_weights={"gold": 2.0, "free": 1.0},
                        device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        tenant = "gold" if i % 3 else "free"
        eng.submit(tenant, list(rng.integers(0, cfg.vocab_size, 12)),
                   max_new_tokens=args.max_new)
    done = eng.run(max_steps=args.requests * args.max_new + 32)
    per_tenant = {}
    for r in done:
        per_tenant.setdefault(r.tenant, 0)
        per_tenant[r.tenant] += len(r.out_tokens)
    print(f"completed {len(done)} requests; tokens/tenant: {per_tenant}")
    return done


if __name__ == "__main__":
    main()
