"""Jamba-v0.1-52B [hybrid]: 32L, d_model 4096, 32H (GQA kv=8), d_ff 14336,
vocab 65536, MoE 16e top-2, Mamba:attention 7:1 interleave
[arXiv:2403.19887; hf]. Mamba layers use the SSD mixer (Mamba-2,
ngroups 1), as the reference's; 51.5 B params, 102.9 GB in bf16, so one
80 GB card serves it only at reduced depth."""
from ..models.config import ModelConfig, jamba_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba_v0_1_52b", num_layers=32, d_model=4096, num_heads=32,
        num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=65536,
        block_pattern=jamba_pattern(), moe_experts=16, moe_top_k=2,
        moe_d_ff=14336, ssm_state=16, ssm_expand=2, ssm_headdim=64,
        rope_type="none", mlp_type="swiglu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba_v0_1_52b_smoke", num_layers=8, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        block_pattern=jamba_pattern(), moe_experts=4, moe_top_k=2,
        moe_d_ff=128, ssm_state=8, ssm_expand=2, ssm_headdim=16,
        ssm_chunk=16, rope_type="none", mlp_type="swiglu",
        dtype="float32", param_dtype="float32",
    )
