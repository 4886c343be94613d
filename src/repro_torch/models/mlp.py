"""Dense MLP blocks: SwiGLU / GeGLU / plain GELU (port of
``repro.models.mlp``; weights ``x @ W`` as in the reference)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .common import ACT, ParamBuilder
from .config import ModelConfig


def init_mlp(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": pb.fan_in((d, f), fan_axis=0),
            "w_up": pb.fan_in((d, f), fan_axis=0),
            "w_down": pb.fan_in((f, d), fan_axis=0),
        }
    return {
        "w_up": pb.fan_in((d, f), fan_axis=0),
        "w_down": pb.fan_in((f, d), fan_axis=0),
    }


def mlp(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp in ("swiglu", "geglu"):
        act = ACT["silu" if cfg.mlp == "swiglu" else "gelu"]
        g = act(x @ params["w_gate"].to(x.dtype))
        u = x @ params["w_up"].to(x.dtype)
        return (g * u) @ params["w_down"].to(x.dtype)
    h = ACT["gelu"](x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)
