"""Mamba2-1.3B [ssm]: 48L, d_model 2048, attention-free, vocab 50280,
ssm_state 128 — SSD (state-space duality) [arXiv:2405.21060]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_1_3b", num_layers=48, d_model=2048, num_heads=0,
        num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
        block_pattern=(("mamba", "none"),), ssm_state=128, ssm_expand=2,
        ssm_headdim=64, ssm_chunk=128, rope_type="none",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_1_3b_smoke", num_layers=2, d_model=64, num_heads=0,
        num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=256,
        block_pattern=(("mamba", "none"),), ssm_state=16, ssm_expand=2,
        ssm_headdim=16, ssm_chunk=16, rope_type="none",
        tie_embeddings=True, dtype="float32", param_dtype="float32",
    )
