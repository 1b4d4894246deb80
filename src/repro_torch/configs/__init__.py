"""Architecture registry of the port: the reference's ids and aliases
(``repro/configs/__init__.py``), with the configs whose blocks the port
has. ``get_config``/``get_smoke_config`` return the same ``ModelConfig``
values as the reference for a ported arch and raise ``NotImplementedError``,
naming what it waits for in ROADMAP.md, for the others.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

ARCH_IDS = (
    "qwen2_5_32b",
    "qwen3_1_7b",
    "granite_3_8b",
    "gemma_2b",
    "jamba_v0_1_52b",
    "mamba2_1_3b",
    "qwen2_vl_72b",
    "granite_moe_3b_a800m",
    "grok_1_314b",
    "musicgen_large",
)

#: archs the port can run, and what each other arch waits for
PORTED = ("qwen3_1_7b", "mamba2_1_3b")
_MOE = "(ROADMAP.md queue 1 item 7, MoE)"
_DENSE = "(ROADMAP.md queue 1 item 8, remaining dense configs)"
_MROPE = "(ROADMAP.md queue 1 item 9, M-RoPE and the frontend stubs)"
WAITS_FOR = {
    "jamba_v0_1_52b": f"models/moe {_MOE}",
    "granite_moe_3b_a800m": f"models/moe {_MOE}",
    "grok_1_314b": f"models/moe {_MOE}",
    "qwen2_vl_72b": f"apply_mrope and the vision frontend stub {_MROPE}",
    "musicgen_large": f"the audio frontend stub and the GELU-MLP config "
                      f"{_MROPE}",
    "gemma_2b": f"head_dim 256 in the attention kernels, which take "
                f"head_dim <= 128 {_DENSE}",
    "qwen2_5_32b": f"its config and parity tests at qkv_bias=True {_DENSE}",
    "granite_3_8b": f"its config and parity tests at untied embeddings "
                    f"{_DENSE}",
}

# public --arch ids (dashes) -> module names
ALIASES = {aid.replace("_", "-"): aid for aid in ARCH_IDS}
ALIASES.update({
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-1.7b": "qwen3_1_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mamba2-1.3b": "mamba2_1_3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "grok-1-314b": "grok_1_314b",
})


def _module(arch: str):
    key = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    if key not in PORTED:
        raise NotImplementedError(
            f"{key} is not ported to repro_torch yet: it waits for "
            f"{WAITS_FOR[key]}")
    return importlib.import_module(f"{__name__}.{key}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
