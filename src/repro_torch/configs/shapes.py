"""Assigned input shapes (same 4 for every LM arch) and applicability rules."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape: Shape) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason (recorded in
    the dry-run table per the assignment's shape rules)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: long_500k needs sub-quadratic attention"
    return None
