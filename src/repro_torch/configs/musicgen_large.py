"""MusicGen-large [audio]: 48L, d_model 2048, 32H (kv=32, full MHA),
d_ff 8192, vocab 2048 — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. The EnCodec frontend is a STUB: input_specs()
provides precomputed frame embeddings (sum of the 4 codebook embeddings,
delay pattern flattened) via frontend="audio_stub"."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen_large", num_layers=48, d_model=2048, num_heads=32,
        num_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=2048,
        mlp_type="gelu", frontend="audio_stub",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen_large_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=64,
        mlp_type="gelu", frontend="audio_stub", dtype="float32",
        param_dtype="float32",
    )
