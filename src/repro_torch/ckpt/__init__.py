"""The port's checkpoint manager (``repro/ckpt``): the reference's layout,
bit-exact in every dtype, bfloat16 included."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
