"""Granite-3.0-3B-A800M [moe]: 32L, d_model 1536, 24H (GQA kv=8), expert
d_ff 512, vocab 49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_moe_3b_a800m", num_layers=32, d_model=1536,
        num_heads=24, num_kv_heads=8, head_dim=64, d_ff=512,
        vocab_size=49155, block_pattern=(("attn", "moe"),),
        moe_experts=40, moe_top_k=8, moe_d_ff=512, mlp_type="swiglu",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite_moe_3b_a800m_smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
        block_pattern=(("attn", "moe"),), moe_experts=8, moe_top_k=4,
        moe_d_ff=32, mlp_type="swiglu", tie_embeddings=True,
        dtype="float32", param_dtype="float32",
    )
