"""Qwen2.5-32B [dense]: 64L, d_model 5120, 40H (GQA kv=8), d_ff 27648,
vocab 152064 — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_5_32b", num_layers=64, d_model=5120, num_heads=40,
        num_kv_heads=8, head_dim=128, d_ff=27648, vocab_size=152064,
        qkv_bias=True, rope_theta=1_000_000.0, mlp_type="swiglu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_5_32b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        qkv_bias=True, mlp_type="swiglu", dtype="float32",
        param_dtype="float32",
    )
