"""Qwen3-1.7B [dense]: 28L, d_model 2048, 16H (GQA kv=8), d_ff 6144,
vocab 151936 — qk_norm + GQA [hf:Qwen/Qwen3-8B family; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_1_7b", num_layers=28, d_model=2048, num_heads=16,
        num_kv_heads=8, head_dim=128, d_ff=6144, vocab_size=151936,
        qk_norm=True, rope_theta=1_000_000.0, mlp_type="swiglu",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_1_7b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        qk_norm=True, mlp_type="swiglu", tie_embeddings=True,
        dtype="float32", param_dtype="float32",
    )
