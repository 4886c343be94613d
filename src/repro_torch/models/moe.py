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
does nothing on one card; ``a2a_mesh`` (a ``(data, model)`` ``DeviceMesh``)
sends every MoE block to ``moe_a2a.moe_block_a2a``, the reference's
``shard_map`` formulation across ranks; ``count_drops`` adds the
assignments dropped at capacity to ``moe_block.dropped`` (a device tensor,
so no host sync) at every call (``moe_block_a2a`` adds its rank's).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..parallel import tensor as tp
from .common import ACT, ParamBuilder
from .config import ModelConfig

MOE_OPTS = {"constrain": False, "a2a_mesh": None, "count_drops": False}


def set_moe_opts(constrain: bool = False, a2a_mesh=None, count_drops: bool = False) -> None:
    MOE_OPTS.update(constrain=bool(constrain), a2a_mesh=a2a_mesh, count_drops=bool(count_drops))


def init_moe(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    assert cfg.moe is not None
    d, m = cfg.d_model, cfg.moe
    f = m.d_ff_expert
    p = {
        "router": pb.normal((d, m.n_experts), ("embed", "experts"), stddev=d ** -0.5),
        "w_gate": pb.fan_in((m.n_experts, d, f), ("experts", "embed", "ff"), fan_axis=1),
        "w_up": pb.fan_in((m.n_experts, d, f), ("experts", "embed", "ff"), fan_axis=1),
        "w_down": pb.fan_in((m.n_experts, f, d), ("experts", "ff", "embed"), fan_axis=1),
    }
    if m.n_shared:
        p["shared_gate"] = pb.fan_in((d, m.n_shared * f), ("embed", "ff"), fan_axis=0)
        p["shared_up"] = pb.fan_in((d, m.n_shared * f), ("embed", "ff"), fan_axis=0)
        p["shared_down"] = pb.fan_in((m.n_shared * f, d), ("ff", "embed"), fan_axis=0)
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


def experts(xf: torch.Tensor, rel_e: torch.Tensor, flat_w: torch.Tensor, n_bins: int, C: int,
            k: int, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
    """Sort-based dispatch of the S*k assignments (token i's j-th choice at
    i*k + j) to ``n_bins`` experts with C slots each, the batched expert
    products and the deterministic combine.  ``rel_e`` is each
    assignment's expert in ``[0, n_bins)``, or ``n_bins`` for one that is
    not here (the drop bin of ``moe_a2a``).  Returns (out (S, D): each
    token's kept choices weighted by ``flat_w`` and summed in order,
    counts (n_bins,), dropped: this call's assignments to its experts past
    capacity)."""
    S, D = xf.shape
    flat_tok = torch.arange(S, device=xf.device).repeat_interleave(k)
    _, order = torch.sort(rel_e, stable=True)
    sorted_tok = flat_tok[order]
    sorted_w = flat_w[order]
    counts = torch.bincount(rel_e, minlength=n_bins + 1)[:n_bins]  # (n_bins,)
    offsets = torch.cumsum(counts, 0) - counts
    # slot (e, c) -> index into the sorted arrays, masked past each count
    cs = torch.arange(C, device=xf.device)
    slot_valid = cs[None, :] < counts[:, None]                     # (n_bins, C)
    slot_idx = torch.clamp(offsets[:, None] + cs[None, :], 0, S * k - 1)
    tok_at_slot = torch.where(slot_valid, sorted_tok[slot_idx], 0)
    w_at_slot = torch.where(slot_valid, sorted_w[slot_idx], 0.0)

    xd = xf[tok_at_slot] * slot_valid[..., None].to(xf.dtype)      # (n_bins, C, D)
    act = ACT["silu"]
    g = act(torch.bmm(xd, w_gate.to(xd.dtype)))
    u = torch.bmm(xd, w_up.to(xd.dtype))
    y = torch.bmm(g * u, w_down.to(xd.dtype))                      # (n_bins, C, D)
    y = y * w_at_slot[..., None].to(y.dtype)

    # ---- deterministic combine: each (token, choice) reads its own slot --
    here = rel_e < n_bins
    e = torch.clamp(rel_e, max=n_bins - 1)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(S * k, device=xf.device)
    rank = rank - offsets[e]                                       # its place in e's queue
    kept = here & (rank < C)
    picked = y.reshape(n_bins * C, D)[e * C + torch.clamp(rank, 0, C - 1)]
    picked = (picked * kept[:, None].to(y.dtype)).view(S, k, D)
    out = picked[:, 0]
    for j in range(1, k):
        out = out + picked[:, j]
    return out, counts, here.sum() - kept.sum()


def moe_block(
    params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out, aux_loss). Aux = load-balance loss (Switch).
    With ``set_moe_opts(a2a_mesh=...)``: ``moe_a2a.moe_block_a2a`` on that
    mesh (x this rank's rows).  DTensor weights otherwise are gathered
    whole (the model axis's ranks compute the block alike)."""
    if MOE_OPTS["a2a_mesh"] is not None:
        from .moe_a2a import moe_block_a2a

        return moe_block_a2a(params, x, cfg, MOE_OPTS["a2a_mesh"])
    params = tp.whole_tree(params)
    m = cfg.moe
    B, T, D = x.shape
    S, E, k = B * T, m.n_experts, m.top_k
    xf = x.reshape(S, D)
    probs, top_w, top_e = route(params, xf, cfg)
    flat_e = top_e.reshape(-1)                                     # (S*k,)
    out, counts, dropped = experts(xf, flat_e, top_w.reshape(-1), E, _capacity(S, m), k,
                                   params["w_gate"], params["w_up"], params["w_down"])
    if MOE_OPTS["count_drops"]:
        moe_block.dropped = moe_block.dropped + dropped
    out = out.to(x.dtype)
    if m.n_shared:
        out = out + shared_experts(params, xf)

    # Switch-style load-balance auxiliary loss.
    me = probs.mean(dim=0)                                         # (E,)
    ce = counts / (S * k)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, T, D), aux.float()


def shared_experts(params: Dict[str, Any], xf: torch.Tensor) -> torch.Tensor:
    act = ACT["silu"]
    gs = act(xf @ params["shared_gate"].to(xf.dtype))
    us = xf @ params["shared_up"].to(xf.dtype)
    return (gs * us) @ params["shared_down"].to(xf.dtype)


moe_block.dropped = 0
