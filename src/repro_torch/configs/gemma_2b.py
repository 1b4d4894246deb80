"""Gemma-2B [dense]: 18L, d_model 2048, 8H (MQA kv=1), d_ff 16384,
vocab 256000 — GeGLU, head_dim 256 [arXiv:2403.08295; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma_2b", num_layers=18, d_model=2048, num_heads=8,
        num_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=256000,
        mlp_type="geglu", tie_embeddings=True, rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma_2b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=256,
        mlp_type="geglu", tie_embeddings=True, dtype="float32",
        param_dtype="float32",
    )
