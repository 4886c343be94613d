"""xLSTM blocks: sLSTM (scalar memory) and mLSTM (matrix memory) (port of
``repro.models.xlstm``).

Faithful to arXiv:2405.04517 cell equations with exponential gating and the
max-stabilizer state m_t:

  sLSTM:  c_t = f' c_{t-1} + i' z ;  n_t = f' n_{t-1} + i' ;  h = o * c/n
  mLSTM:  C_t = f' C_{t-1} + i' v k^T ;  n_t = f' n_{t-1} + i' k
          h~  = C_t q / max(|n_t . q|, 1) ;  h = o * h~
  where  m_t = max(f~ + m_{t-1}, i~),  i' = exp(i~ - m_t),
         f' = exp(f~ + m_{t-1} - m_t).

Each cell is a Python loop over time, as the reference's ``lax.scan`` is:
an exact recurrence with O(1) state in the sequence length.  On the card
a prefill is launch-bound (a step is some twenty small launches a layer).
Block-level simplifications vs. the paper's figure-9 skeleton are the
reference's: the mLSTM block's causal conv is omitted; projections are
fused per cell.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ParamBuilder
from .config import ModelConfig

_M0 = -1e30  # the stabiliser's start: the first step's f' is exp(-inf) = 0


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    # input projections for (z, i, f, o); recurrent weights are block-diagonal
    # per head: (H, dh, dh).
    return {
        "w_in": pb.fan_in((d, 4, H, dh), ("embed", None, "heads", "head_dim"), fan_axis=0),
        "r": pb.fan_in((4, H, dh, dh), (None, "heads", "head_dim", None), fan_axis=2),
        "b": pb.zeros((4, H, dh), (None, "heads", "head_dim")),
        "w_out": pb.fan_in((H, dh, d), ("heads", "head_dim", "embed"), fan_axis=(0, 1)),
    }


def slstm(
    params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, D). state: {c, n, m, h} each (B, H, dh). Returns (y, state')."""
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H
    if state is None:
        state = init_slstm_state(cfg, B, x.device)

    w_in = params["w_in"].to(x.dtype)
    pre = (x @ w_in.reshape(D, 4 * H * dh)).view(B, T, 4, H, dh)  # (B,T,4,H,dh)
    r = params["r"].float()
    b = params["b"].float()
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hs = []
    for t in range(T):
        # recurrent contribution from h_{t-1} (block-diagonal per head)
        rec = torch.einsum("bhk,ghkl->bghl", h, r)                 # (B,4,H,dh)
        g = pre[:, t].float() + rec + b
        z_t = torch.tanh(g[:, 0])
        i_t = g[:, 1]
        f_t = g[:, 2]
        o_t = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(f_t + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(f_t + m - m_new)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * c / torch.clamp(torch.abs(n), min=1e-6)
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(x.dtype)                        # (B,T,H,dh)
    y = hs.reshape(B, T, H * dh) @ params["w_out"].to(x.dtype).reshape(H * dh, D)
    return y, {"c": c, "n": n, "m": m, "h": h}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d, H = cfg.d_model, cfg.n_heads
    di = int(d * cfg.mlstm_proj_factor)
    dh = di // H
    return {
        "w_up": pb.fan_in((d, di), ("embed", "ff"), fan_axis=0),
        "w_gate": pb.fan_in((d, di), ("embed", "ff"), fan_axis=0),
        "wq": pb.fan_in((di, H, dh), ("ff", "heads", "head_dim"), fan_axis=0),
        "wk": pb.fan_in((di, H, dh), ("ff", "heads", "head_dim"), fan_axis=0),
        "wv": pb.fan_in((di, H, dh), ("ff", "heads", "head_dim"), fan_axis=0),
        "w_if": pb.fan_in((di, 2, H), ("ff", None, "heads"), fan_axis=0),
        "b_if": pb.const(torch.tensor([[0.0], [1.0]]), (None, "heads")),
        "w_down": pb.fan_in((di, d), ("ff", "embed"), fan_axis=0),
    }


def _proj(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bti,i...->bt..."): (B, T, di) x (di, a, b) -> (B, T, a, b)."""
    return (u @ w.to(u.dtype).reshape(w.shape[0], -1)).view(*u.shape[:2], *w.shape[1:])


def mlstm(
    params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, D). state: {C (B,H,dh,dh), n (B,H,dh), m (B,H)}."""
    B, T, D = x.shape
    H = cfg.n_heads
    di = int(D * cfg.mlstm_proj_factor)
    dh = di // H
    up = x @ params["w_up"].to(x.dtype)                            # (B,T,di)
    gate = F.silu(x @ params["w_gate"].to(x.dtype))
    q = _proj(up, params["wq"])                                    # (B,T,H,dh)
    k = _proj(up, params["wk"]) / (dh ** 0.5)
    v = _proj(up, params["wv"])
    gif = _proj(up, params["w_if"]).float() + params["b_if"].float()  # (B,T,2,H)

    if state is None:
        state = init_mlstm_state(cfg, B, x.device)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(T):
        i_t, f_t = gif[:, t, 0], F.logsigmoid(gif[:, t, 1])        # (B,H)
        m_new = torch.maximum(f_t + m, i_t)
        i_p = torch.exp(i_t - m_new)[..., None]                    # (B,H,1)
        f_p = torch.exp(f_t + m - m_new)[..., None]
        kf, vf, qf = k[:, t].float(), v[:, t].float(), q[:, t].float()
        C = f_p[..., None] * C + i_p[..., None] * vf[..., :, None] * kf[..., None, :]
        n = f_p * n + i_p * kf
        num = (C @ qf[..., None])[..., 0]                          # (B,H,dh)
        den = torch.clamp(torch.abs((n * qf).sum(-1)), min=1.0)
        hs.append(num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, T, di).to(x.dtype)      # merge heads
    y = (h * gate) @ params["w_down"].to(x.dtype)
    return y, {"C": C, "n": n, "m": m}


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads

    def z():
        return torch.zeros((batch, H, dh), dtype=torch.float32, device=device)

    return {"c": z(), "n": z(),
            "m": torch.full((batch, H, dh), _M0, dtype=torch.float32, device=device), "h": z()}


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    H = cfg.n_heads
    di = int(cfg.d_model * cfg.mlstm_proj_factor)
    dh = di // H
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, H), _M0, dtype=torch.float32, device=device),
    }
