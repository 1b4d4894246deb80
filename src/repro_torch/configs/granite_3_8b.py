"""Granite-3.0-8B [dense]: 40L, d_model 4096, 32H (GQA kv=8), d_ff 12800,
vocab 49155 [hf:ibm-granite/granite-3.0-2b-base family; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_3_8b", num_layers=40, d_model=4096, num_heads=32,
        num_kv_heads=8, head_dim=128, d_ff=12800, vocab_size=49155,
        rope_theta=10_000.0, mlp_type="swiglu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite_3_8b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=251,
        mlp_type="swiglu", dtype="float32", param_dtype="float32",
    )
