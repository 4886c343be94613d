"""Mixture-of-Experts block with sort-based (dropping, capacity-bounded)
token dispatch (port of ``repro.models.moe``).

  1. router scores -> top_k expert ids + weights per token;
  2. flatten the S*k assignments, sort them by expert id (stable);
  3. each expert e gets a (C,) slot table: slot (e, c) holds the c-th token
     assigned to e (or nothing beyond its count: capacity drop, GShard
     semantics);
  4. gather -> (E, C, d), batched expert products, weighted by the router.

The reference scatter-adds the slots back with ``segment_sum``.  On the
card an index-add adds with atomics, whose order, and so whose last bits,
change from run to run; the port inverts the slot table instead, reading
each (token, choice)'s slot, and sums a token's k contributions in the
order of its choices, so two runs are bitwise equal.

``set_moe_opts``: ``constrain`` is the reference's GSPMD sharding hint and
does nothing on one card; ``a2a_mesh`` (the ``shard_map`` formulation)
waits for the port's multi-rank slice; ``count_drops`` adds the
assignments dropped at capacity to ``moe_block.dropped`` (a device tensor,
so no host sync) at every call.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .common import ACT, ParamBuilder
from .config import ModelConfig

MOE_OPTS = {"constrain": False, "a2a_mesh": None, "count_drops": False}


def set_moe_opts(constrain: bool = False, a2a_mesh=None, count_drops: bool = False) -> None:
    if a2a_mesh is not None:
        raise NotImplementedError(
            "the shard_map all-to-all MoE (moe_a2a) waits for slice C5 of the port "
            "(the multi-rank paths, ROADMAP queue 1)")
    MOE_OPTS.update(constrain=bool(constrain), a2a_mesh=None, count_drops=bool(count_drops))


def init_moe(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    assert cfg.moe is not None
    d, m = cfg.d_model, cfg.moe
    f = m.d_ff_expert
    p = {
        "router": pb.normal((d, m.n_experts), stddev=d ** -0.5),
        "w_gate": pb.fan_in((m.n_experts, d, f), fan_axis=1),
        "w_up": pb.fan_in((m.n_experts, d, f), fan_axis=1),
        "w_down": pb.fan_in((m.n_experts, f, d), fan_axis=1),
    }
    if m.n_shared:
        p["shared_gate"] = pb.fan_in((d, m.n_shared * f), fan_axis=0)
        p["shared_up"] = pb.fan_in((d, m.n_shared * f), fan_axis=0)
        p["shared_down"] = pb.fan_in((m.n_shared * f, d), fan_axis=0)
    return p


def _capacity(s_tokens: int, m) -> int:
    c = int(s_tokens * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(c, m.top_k)


def route(params: Dict[str, Any], xf: torch.Tensor, cfg: ModelConfig):
    """The router: (probs (S, E) fp32, top_w (S, k) renormalised, top_e (S, k))."""
    m = cfg.moe
    logits = (xf @ params["router"].to(xf.dtype)).float()         # (S, E)
    if m.router_softcap:
        logits = m.router_softcap * torch.tanh(logits / m.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, m.top_k, dim=-1)              # (S, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def moe_block(
    params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out, aux_loss). Aux = load-balance loss (Switch)."""
    m = cfg.moe
    B, T, D = x.shape
    S, E, k = B * T, m.n_experts, m.top_k
    xf = x.reshape(S, D)
    probs, top_w, top_e = route(params, xf, cfg)

    # ---- sort-based dispatch -------------------------------------------
    C = _capacity(S, m)
    flat_e = top_e.reshape(-1)                                     # (S*k,)
    flat_w = top_w.reshape(-1)
    flat_tok = torch.arange(S, device=x.device).repeat_interleave(k)
    _, order = torch.sort(flat_e, stable=True)
    sorted_tok = flat_tok[order]
    sorted_w = flat_w[order]
    counts = torch.bincount(flat_e, minlength=E)                   # (E,)
    offsets = torch.cumsum(counts, 0) - counts
    # slot (e, c) -> index into the sorted arrays, masked past each count
    cs = torch.arange(C, device=x.device)
    slot_valid = cs[None, :] < counts[:, None]                     # (E, C)
    slot_idx = torch.clamp(offsets[:, None] + cs[None, :], 0, S * k - 1)
    tok_at_slot = torch.where(slot_valid, sorted_tok[slot_idx], 0)
    w_at_slot = torch.where(slot_valid, sorted_w[slot_idx], 0.0)

    xd = xf[tok_at_slot] * slot_valid[..., None].to(x.dtype)       # (E, C, D)
    act = ACT["silu"]
    g = act(torch.bmm(xd, params["w_gate"].to(xd.dtype)))
    u = torch.bmm(xd, params["w_up"].to(xd.dtype))
    y = torch.bmm(g * u, params["w_down"].to(xd.dtype))            # (E, C, D)
    y = y * w_at_slot[..., None].to(y.dtype)

    # ---- deterministic combine: each (token, choice) reads its own slot --
    rank = torch.empty_like(order)
    rank[order] = torch.arange(S * k, device=x.device)
    rank = rank - offsets[flat_e]                                  # its place in e's queue
    kept = rank < C
    if MOE_OPTS["count_drops"]:
        moe_block.dropped = moe_block.dropped + (S * k - kept.sum())
    picked = y.reshape(E * C, D)[flat_e * C + torch.clamp(rank, max=C - 1)]
    picked = (picked * kept[:, None].to(y.dtype)).view(S, k, D)
    out = picked[:, 0]
    for j in range(1, k):
        out = out + picked[:, j]
    out = out.to(x.dtype)

    if m.n_shared:
        gs = act(xf @ params["shared_gate"].to(x.dtype))
        us = xf @ params["shared_up"].to(x.dtype)
        out = out + (gs * us) @ params["shared_down"].to(x.dtype)

    # Switch-style load-balance auxiliary loss.
    me = probs.mean(dim=0)                                         # (E,)
    ce = counts / (S * k)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, T, D), aux.float()


moe_block.dropped = 0
