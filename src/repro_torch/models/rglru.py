"""RecurrentGemma / Griffin recurrent block: causal conv + RG-LRU (port of
``repro.models.rglru``).

RG-LRU (arXiv:2402.19427):
  r_t = sigmoid(W_a x_t + b_a)            recurrence gate
  i_t = sigmoid(W_x x_t + b_x)            input gate
  log a_t = -c * softplus(Lambda) * r_t   (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill scans the linear recurrence h_t = a_t h_{t-1} + b_t with the
odd/even recursion of ``jax.lax.associative_scan`` (:func:`associative_scan`
on the pair combine ``(a1 a2, a2 b1 + b2)``): O(log T) levels of a few
element-wise launches each, where a token loop would launch per token.  The
reference has no Pallas kernel here.  Decode is the same scan over one step
with the carried state absorbed as a virtual first step.

Block layout (Griffin fig. 2): two branches from the input — (linear ->
GeLU) gate and (linear -> causal conv1d(4) -> RG-LRU) — merged by product,
then down-projected.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ACT, ParamBuilder
from .config import ModelConfig

_C = 8.0


def init_rglru_block(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    w = cfg.lru_width or d
    cw = cfg.conv_width
    a = torch.linspace(0.9, 0.999, w, dtype=torch.float32)
    return {
        "w_gate": pb.fan_in((d, w), ("embed", "state"), fan_axis=0),
        "w_x": pb.fan_in((d, w), ("embed", "state"), fan_axis=0),
        "conv": pb.normal((cw, w), (None, "state"), stddev=cw ** -0.5),
        "conv_b": pb.zeros((w,), ("state",)),
        "wa": pb.fan_in((w, w), ("state", None), fan_axis=0),
        "ba": pb.zeros((w,), ("state",)),
        "wi": pb.fan_in((w, w), ("state", None), fan_axis=0),
        "bi": pb.zeros((w,), ("state",)),
        # Lambda init so that a (at r=1) is uniform in [0.9, 0.999]:
        # log a = -c*softplus(Lambda)  =>  Lambda = log(expm1(-log(a)/c))
        "lam": pb.const(torch.log(torch.expm1(-torch.log(a) / _C)), ("state",)),
        "w_down": pb.fan_in((w, d), ("state", "embed"), fan_axis=0),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along T. x: (B, T, W); kernel: (cw, W).
    prev: (B, cw-1, W) history for decode. Returns (y, new_prev)."""
    cw, T = kernel.shape[0], x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)                              # (B, T+cw-1, W)
    y = xp[:, 0:T] * kernel[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + T] * kernel[i]
    y = y + bias
    new_prev = xp[:, -(cw - 1):] if cw > 1 else prev
    return y.to(x.dtype), new_prev


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the pairs (a_t, b_t) along dim 1 under
    :func:`_combine`, by ``jax.lax.associative_scan``'s recursion: combine
    adjacent pairs, scan those, then fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    out = []
    for first, e, o in zip((a, b), even, odd):
        r = torch.empty_like(first)
        r[:, 0:1] = first[:, 0:1]
        r[:, 2::2] = e
        r[:, 1::2] = o
        out.append(r)
    return out[0], out[1]


def _rglru_scan(xs: torch.Tensor, params, h0: Optional[torch.Tensor]):
    """xs: (B, T, W) conv output. Returns (h (B,T,W), h_last)."""
    x = xs.float()
    r = torch.sigmoid(x @ params["wa"].float() + params["ba"].float())
    i = torch.sigmoid(x @ params["wi"].float() + params["bi"].float())
    log_a = -_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=0.0)) * (i * x)
    if h0 is not None:
        # absorb the carried state as a virtual first step: h_0 given.
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None, :].float(), b], dim=1)
    _, h = associative_scan(a, b)
    if h0 is not None:
        h = h[:, 1:]
    return h, h[:, -1]


def rglru_block(
    params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, D). state: {"h": (B, W), "conv": (B, cw-1, W)}."""
    gate = ACT["gelu"](x @ params["w_gate"].to(x.dtype))
    u = x @ params["w_x"].to(x.dtype)
    prev = state["conv"].to(x.dtype) if state is not None else None
    u, new_conv = _causal_conv(u, params["conv"].to(x.dtype), params["conv_b"].to(x.dtype), prev)
    h0 = state["h"] if state is not None else None
    h, h_last = _rglru_scan(u, params, h0)
    y = (h.to(x.dtype) * gate) @ params["w_down"].to(x.dtype)
    return y, {"h": h_last, "conv": new_conv}


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=torch.float32, device=device),
    }
