"""Training launcher: the restart-safe loop on one card, the port of
``repro/launch/train.py``, with ``--device`` and ``--dtype``.

Usage:
    python -m repro_torch.launch.train --arch qwen3_1_7b --smoke --steps 50
    python -m repro_torch.launch.train --arch qwen3_1_7b --smoke --steps 8 \
        --device cpu
A second run on the same ``--ckpt-dir`` resumes from its latest checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..configs import get_config, get_smoke_config
from ..data import DataConfig
from ..train import OptimizerConfig
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config sized for CPU")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_train")
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
    oc = OptimizerConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                         decay_steps=args.steps,
                         state_dtype=cfg.opt_state_dtype)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    tc = TrainerConfig(total_steps=args.steps,
                       ckpt_every=max(args.steps // 4, 1),
                       log_every=max(args.steps // 20, 1),
                       ckpt_dir=args.ckpt_dir,
                       microbatches=args.microbatches)
    trainer = Trainer(cfg, oc, tc, dc, device=args.device)
    print(f"device: {trainer.device}")
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M")
    start = trainer.init_or_restore()
    print(f"starting at step {start}")
    out = trainer.run()
    if out["losses"]:
        print(f"done: final loss {out['losses'][-1]:.4f}")
    else:       # the directory's latest checkpoint is already the last step
        print(f"done: nothing to run past step {start}")
    return out


if __name__ == "__main__":
    main()
