"""The training loop: data pipeline + train step + checkpointing + fault
hooks, in one restart-safe loop; the port of ``repro/train/trainer.py``.

A job restarted on a checkpoint directory resumes from its latest step:
the data is a pure function of the step and the restore is bit-exact, so on
the CPU the resumed steps repeat the first run's losses exactly (on the
card the backward's atomics leave the step not bit-deterministic).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from ..ckpt.manager import CheckpointManager
from ..data.pipeline import DataConfig, global_batch_at_torch
from ..device import DeviceLike, resolve_device
from ..ft.failures import StragglerDetector
from ..models.config import ModelConfig
from ..models.model import init_params
from .optimizer import OptimizerConfig
from .step import build_train_step_torch, make_train_state_torch


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    ckpt_dir: str = "artifacts/ckpt"
    microbatches: int = 1
    seed: int = 0


class Trainer:
    """Runs ``tc.total_steps`` steps of ``build_train_step_torch`` on
    ``device`` (the card by default) over ``global_batch_at_torch``'s
    batches, saving every ``ckpt_every`` steps and once, blocking, at the
    end. Each step's time runs up to the host's read of its loss, which
    waits for the device, so the straggler detector sees the device's time
    and not the launches'."""

    def __init__(self, cfg: ModelConfig, oc: OptimizerConfig,
                 tc: TrainerConfig, data_cfg: DataConfig,
                 hooks: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.cfg, self.oc, self.tc, self.data_cfg = cfg, oc, tc, data_cfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tc.ckpt_dir)
        self.step_fn = build_train_step_torch(cfg, oc, tc.microbatches,
                                              self.device)
        self.straggler = StragglerDetector()
        self.hooks = hooks
        self.state = None
        self.start_step = 0

    def init_or_restore(self):
        """Fresh params from ``tc.seed`` and zero moments, then the latest
        checkpoint's values copied into them if there is one; returns the
        step the run starts at."""
        params = init_params(self.cfg, self.tc.seed, device=self.device)
        self.state = make_train_state_torch(self.cfg, params, self.oc,
                                            self.device)
        latest = self.ckpt.latest_step()
        if latest is not None:
            self.state = self.ckpt.restore(latest, target=self.state)
            self.start_step = latest
        return self.start_step

    def run(self) -> dict:
        if self.state is None:
            self.init_or_restore()
        losses = []
        for step in range(self.start_step, self.tc.total_steps):
            batch = global_batch_at_torch(self.data_cfg, step, self.device)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.straggler.record("worker0", dt)
            losses.append(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
            if (step + 1) % self.tc.log_every == 0:
                print(f"step {step + 1}: loss={loss:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if (step + 1) % self.tc.ckpt_every == 0:
                self.ckpt.save(step + 1, self.state)
            if self.hooks:
                self.hooks(step, self.state, metrics)
        self.ckpt.save(self.tc.total_steps, self.state, block=True)
        return {"losses": losses, "final_step": self.tc.total_steps}
