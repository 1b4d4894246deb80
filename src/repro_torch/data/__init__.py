"""The port's data pipeline (``repro/data``): step-addressable synthetic
token batches as tensors on the card."""
from .pipeline import DataConfig, SyntheticTokenPipeline, global_batch_at_torch

__all__ = ["DataConfig", "SyntheticTokenPipeline", "global_batch_at_torch"]
