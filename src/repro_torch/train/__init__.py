"""The training side of the port: AdamW (``optimizer``), the train step
with microbatching (``step``), int8 error-feedback compression
(``compression``) and the restart-safe loop (``trainer``), the
counterparts of ``repro/train/``'s modules of those names."""
from .compression import (BLOCK, dequantize_int8_torch,
                          ef_compress_decompress_torch, init_residuals_torch,
                          quantize_int8_torch, wire_bytes_ratio_np)
from .optimizer import (OptimizerConfig, adamw_update_torch, global_norm_torch,
                        init_opt_state_torch, lr_schedule_torch)
from .step import build_train_step_torch, make_train_state_torch
from .trainer import Trainer, TrainerConfig

__all__ = ["BLOCK", "OptimizerConfig", "Trainer", "TrainerConfig",
           "adamw_update_torch", "build_train_step_torch",
           "dequantize_int8_torch", "ef_compress_decompress_torch",
           "global_norm_torch", "init_opt_state_torch", "init_residuals_torch",
           "lr_schedule_torch", "make_train_state_torch",
           "quantize_int8_torch", "wire_bytes_ratio_np"]
