"""Architecture registry of the port: the reference's ids and aliases
(``repro/configs/__init__.py``), with the configs whose blocks the port
has. ``get_config``/``get_smoke_config`` return the same ``ModelConfig``
values as the reference. Every arch is ported; an arch missing from
``PORTED`` would raise ``NotImplementedError`` naming what it waits for in
ROADMAP.md (``WAITS_FOR``). ``SHAPES`` are the reference's four assigned
input shapes, which ``launch/dryrun.py`` traces.
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

#: archs the port can run (every one), and what each other arch waits for
PORTED = ARCH_IDS
WAITS_FOR: dict = {}

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


# ---- assigned input shapes (per-arch set; LM family: all four) -------------
# The reference's ``ShapeSpec``/``SHAPES``/``shape_applicable``/``all_cells``
# (``repro/configs/__init__.py:59-88``), copied with the same values; the
# functions take names of their own (``_np``).

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs.
SUBQUADRATIC_ARCHS = {"jamba_v0_1_52b", "mamba2_1_3b"}


def shape_applicable_np(arch: str, shape: str) -> bool:
    aid = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if shape == "long_500k":
        return aid in SUBQUADRATIC_ARCHS
    return True


def all_cells_np():
    """The 40 assigned (arch x shape) cells, with applicability flag."""
    for aid in ARCH_IDS:
        for sname in SHAPES:
            yield aid, sname, shape_applicable_np(aid, sname)
