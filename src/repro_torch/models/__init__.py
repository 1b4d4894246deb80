"""The port's model layer (``repro/models``), for serving: dense attention
blocks with the flash (prefill) and decode attention kernels."""
from .config import ModelConfig
from .model import (Transformer, forward_decode, forward_prefill, init_caches,
                    init_params)

__all__ = ["ModelConfig", "Transformer", "init_params", "forward_prefill",
           "forward_decode", "init_caches"]
