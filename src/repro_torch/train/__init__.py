"""The training step of the port: AdamW (``optimizer``) and the train
step with microbatching (``step``), the counterparts of
``repro/train/optimizer.py`` and ``repro/train/step.py``."""
from .optimizer import (OptimizerConfig, adamw_update_torch, global_norm_torch,
                        init_opt_state_torch, lr_schedule_torch)
from .step import build_train_step_torch, make_train_state_torch

__all__ = ["OptimizerConfig", "adamw_update_torch", "global_norm_torch",
           "init_opt_state_torch", "lr_schedule_torch",
           "build_train_step_torch", "make_train_state_torch"]
