"""Experiment configurations of the port (copies of ``repro.configs``).

``ccp_paper`` holds the paper's simulation setups; the architecture modules,
``shapes`` and the ``--arch`` registry below are verbatim copies of the
reference's pure dataclass code, built on the port's ``models.config``.
"""

from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig
from . import (
    gemma2_27b,
    granite_20b,
    llava_next_34b,
    mistral_nemo_12b,
    moonshot_v1_16b_a3b,
    phi4_mini_3p8b,
    qwen3_moe_235b_a22b,
    recurrentgemma_2b,
    whisper_large_v3,
    xlstm_350m,
)
from .shapes import SHAPES, Shape, applicable  # noqa: F401

_MODULES = [
    moonshot_v1_16b_a3b,
    qwen3_moe_235b_a22b,
    gemma2_27b,
    granite_20b,
    mistral_nemo_12b,
    phi4_mini_3p8b,
    whisper_large_v3,
    xlstm_350m,
    recurrentgemma_2b,
    llava_next_34b,
]

REGISTRY: Dict[str, object] = {m.ID: m for m in _MODULES}
ARCH_IDS = list(REGISTRY.keys())


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    cfg = REGISTRY[arch].smoke_config() if smoke else REGISTRY[arch].config()
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
