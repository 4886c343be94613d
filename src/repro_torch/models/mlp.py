"""Dense MLP blocks: SwiGLU / GeGLU / plain GELU (port of
``repro.models.mlp``; weights ``x @ W`` as in the reference).

DTensor weights split over the model axis along ff (the rules' ``ff ->
model``) run column- then row-parallel: each rank its ff columns, the
down projection's partial sums added over the axis
(``parallel.tensor``); laid out otherwise, the ranks gather them whole."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..parallel import tensor as tp
from .common import ACT, ParamBuilder
from .config import ModelConfig


def init_mlp(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": pb.fan_in((d, f), ("embed", "ff"), fan_axis=0),
            "w_up": pb.fan_in((d, f), ("embed", "ff"), fan_axis=0),
            "w_down": pb.fan_in((f, d), ("ff", "embed"), fan_axis=0),
        }
    return {
        "w_up": pb.fan_in((d, f), ("embed", "ff"), fan_axis=0),
        "w_down": pb.fan_in((f, d), ("ff", "embed"), fan_axis=0),
    }


def mlp(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if tp.is_dtensor(params["w_up"]):
        names = [n for n in ("w_gate", "w_up") if n in params]
        ws, group = tp.split(*[(params[n], 1) for n in names], (params["w_down"], 0))
        y = mlp(dict(zip(names + ["w_down"], ws)), tp.copy_to(x, group), cfg)
        return tp.reduce_from(y, group)
    if cfg.mlp in ("swiglu", "geglu"):
        act = ACT["silu" if cfg.mlp == "swiglu" else "gelu"]
        g = act(x @ params["w_gate"].to(x.dtype))
        u = x @ params["w_up"].to(x.dtype)
        return (g * u) @ params["w_down"].to(x.dtype)
    h = ACT["gelu"](x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)
