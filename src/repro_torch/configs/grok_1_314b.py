"""Grok-1-314B [moe]: 64L, d_model 6144, 48H (GQA kv=8), d_ff 32768,
vocab 131072, MoE 8e top-2, GELU experts [hf:xai-org/grok-1; unverified].
The reference's values, its bfloat16 optimizer moments included (a
training setting the serving port does not read); 213.4 B params by
``param_count``, 426.8 GB in bf16: one card serves it at reduced depth."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok_1_314b", num_layers=64, d_model=6144, num_heads=48,
        num_kv_heads=8, head_dim=128, d_ff=32768, vocab_size=131072,
        block_pattern=(("attn", "moe"),), moe_experts=8, moe_top_k=2,
        moe_d_ff=32768, mlp_type="gelu", opt_state_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok_1_314b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        block_pattern=(("attn", "moe"),), moe_experts=4, moe_top_k=2,
        moe_d_ff=128, mlp_type="gelu", dtype="float32",
        param_dtype="float32",
    )
