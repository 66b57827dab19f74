"""Assigned architectures (10): the port's own copy of ``repro.configs``.

The port imports nothing of the JAX package, so it keeps these copies;
``tests/test_torch_port.py`` holds each one to its original.  The paper's
HPCC benchmark config is copied too, as ``configs/hpcc.py``: the STREAM
probe on the card (``chip_smoke.py``, phase ``stream``) reads its size.

``get_config("<id>")`` accepts hyphenated public ids (``--arch qwen2-7b``).
Every entry carries its exact public-literature hyperparameters; smoke
tests use ``get_config(id).reduced()``.

Shape cells: each arch pairs with the four assigned input shapes;
``long_500k`` runs only for sub-quadratic archs (SSM/hybrid) — full
attention at 524k decode is skipped per DESIGN.md §5.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..models.config import ModelConfig

ARCH_IDS = [
    "qwen2-vl-72b",
    "minicpm-2b",
    "qwen2-7b",
    "nemotron-4-15b",
    "gemma-2b",
    "zamba2-2.7b",
    "musicgen-medium",
    "qwen3-moe-235b-a22b",
    "deepseek-moe-16b",
    "rwkv6-1.6b",
]


def get_config(arch_id: str) -> ModelConfig:
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.config()


def list_archs() -> list[str]:
    return list(ARCH_IDS)


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic sequence mixing (DESIGN.md §5)."""
    if shape == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


def all_cells() -> list[tuple[str, str]]:
    """All 40 (arch, shape) cells; inapplicable ones included as skips."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
