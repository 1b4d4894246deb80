"""Model configuration schema: the port's own copy of
``repro/models/config.py::ModelConfig`` (that module is jax-free, but the
port imports nothing of ``repro``).

One decoder "group" is described by ``block_pattern`` — a tuple of block
specs, each ``(mixer, mlp)`` with mixer in {"attn", "mamba"} and mlp in
{"dense", "moe", "none"}. The layer stack is ``num_layers = groups *
len(block_pattern)``; the port runs it as a loop over layers, group-major.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

BlockSpec = Tuple[str, str]          # (mixer, mlp)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[BlockSpec, ...] = (("attn", "dense"),)

    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_type: str = "rope"            # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # qwen2-vl half-dim split
    sliding_window: int = 0            # 0 = full attention
    attn_flash_block: int = 1024       # >0: online-softmax over KV blocks of
                                       # this size (flash-jnp path with
                                       # custom-vjp backward; 0 = naive S^2
                                       # reference attention). Default on —
                                       # hillclimb iteration A1 (EXPERIMENTS
                                       # .md §Perf); only active when
                                       # seq > block.
    decode_cache_update: str = "select"  # select | dus — "select" (masked
                                       # where on the cache) avoids GSPMD's
                                       # involuntary cache rematerialization
                                       # when the KV cache is seq-sharded;
                                       # "dus" is the naive baseline
    moe_impl: str = "gather"           # gather (vmapped scatter/gather
                                       # routing, no T*E*C dispatch matmuls —
                                       # hillclimb B2) | dense (GShard
                                       # one-hot einsum baseline)
    cache_dtype: str = ""              # KV-cache storage dtype override
                                       # (e.g. float8_e4m3fn for quantized
                                       # KV; empty = compute dtype)

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                  # expert hidden dim (defaults to d_ff)
    moe_capacity_factor: float = 1.25

    # Mamba / SSD
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # embeddings / head
    mlp_type: str = "swiglu"           # swiglu | geglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # modality frontend stub (precomputed embeddings merged into the stream)
    frontend: str = "none"             # none | vision_stub | audio_stub

    # activation-sharding constraints (set by the launcher; empty = off)
    dp_axes: Tuple[str, ...] = ()      # mesh axes carrying the batch dim
    tp_axis: str = ""                  # mesh axis carrying wide dims

    # numerics / performance knobs (hillclimb levers)
    dtype: str = "bfloat16"            # activations/weights compute dtype
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # AdamW moments
    remat: str = "full"                # full | dots | none
    scan_groups: bool = True

    # ---- derived -----------------------------------------------------------
    @property
    def groups(self) -> int:
        if self.num_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern length {len(self.block_pattern)}")
        return self.num_layers // len(self.block_pattern)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:          # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded so tensor-parallel sharding divides
        evenly (Megatron-style vocab padding); multiple of 256 (or 8 for
        tiny smoke vocabularies)."""
        mult = 256 if self.vocab_size >= 1024 else 8
        return ((self.vocab_size + mult - 1) // mult) * mult

    def has_mixer(self, mixer: str) -> bool:
        return any(b[0] == mixer for b in self.block_pattern)

    def has_moe(self) -> bool:
        return any(b[1] == "moe" for b in self.block_pattern)

    def param_count(self) -> int:
        """Total parameters (for 6*N*D model-FLOPs accounting)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for mixer, mlp in self.block_pattern:
            if mixer == "attn":
                total_attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                if self.qkv_bias:
                    total_attn += self.q_dim + 2 * self.kv_dim
                total += self.groups * total_attn
            elif mixer == "mamba":
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                conv_dim = di + 2 * ns
                m = (d * (2 * di + 2 * ns + nh)        # in_proj (z,x,B,C,dt)
                     + conv_dim * self.ssm_conv        # depthwise conv
                     + nh * 2                          # A_log, D
                     + di * d)                         # out_proj
                total += self.groups * m
            if mlp == "dense":
                mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                total += self.groups * mult * d * self.d_ff
            elif mlp == "moe":
                mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                total += self.groups * (self.moe_experts * mult * d *
                                        self.expert_d_ff + d * self.moe_experts)
            total += self.groups * 2 * d               # pre-norms
        total += d                                     # final norm
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of moe_experts)."""
        if not self.has_moe():
            return self.param_count()
        d = self.d_model
        mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        dense_total = self.param_count()
        moe_layers = self.groups * sum(1 for b in self.block_pattern
                                       if b[1] == "moe")
        all_expert = moe_layers * self.moe_experts * mult * d * self.expert_d_ff
        active_expert = moe_layers * self.moe_top_k * mult * d * self.expert_d_ff
        return dense_total - all_expert + active_expert


def jamba_pattern() -> Tuple[BlockSpec, ...]:
    """Jamba 8-layer period: attention at index 3 (1:7 ratio), MoE on every
    other layer (arXiv:2403.19887)."""
    pattern = []
    for idx in range(8):
        mixer = "attn" if idx == 3 else "mamba"
        mlp = "moe" if idx % 2 == 1 else "dense"
        pattern.append((mixer, mlp))
    return tuple(pattern)
