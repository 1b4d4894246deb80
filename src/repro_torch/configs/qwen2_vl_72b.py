"""Qwen2-VL-72B [vlm backbone]: 80L, d_model 8192, 64H (GQA kv=8),
d_ff 29568, vocab 152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings merged into the token stream (frontend="vision_stub")."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_vl_72b", num_layers=80, d_model=8192, num_heads=64,
        num_kv_heads=8, head_dim=128, d_ff=29568, vocab_size=152064,
        qkv_bias=True, rope_type="mrope", mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0, mlp_type="swiglu", frontend="vision_stub",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_vl_72b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        qkv_bias=True, rope_type="mrope", mrope_sections=(2, 3, 3),
        mlp_type="swiglu", frontend="vision_stub", dtype="float32",
        param_dtype="float32",
    )
