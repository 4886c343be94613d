"""Explicit expert-parallel MoE across ranks (port of
``repro.models.moe_a2a``, the reference's ``shard_map`` formulation).

Within one data shard the activations are replicated over the model axis,
so rank (d, m) already holds every token its local experts E_m need.  Per
rank:

  1. router and top-k on the local tokens;
  2. all-gather of the local experts' ff slices over 'data', when the rules
     shard ff there (FSDP; the reference's qwen3-235b at full width);
  3. dispatch of the local tokens to the local experts, assignments to
     other ranks' experts into a drop bin (no communication);
  4. the expert products, batched matmuls (the reference too computes them
     outside any Pallas kernel);
  5. the combine back to token positions, then a sum over 'model' (each
     token's top-k experts live across model ranks);
  6. the load-balance statistics as means over 'data'.

Capacity applies per data shard, as in the reference, so with one data
rank it is ``moe.moe_block``'s global capacity and the same assignments
drop.  The combine is ``moe.experts``' (each assignment reads its slot, a
token's choices summed in order): bitwise repeatable on the card, where an
index-add's atomics are not.

Forward semantics are the reference's.  The backward is the gradient of
the global loss once the step averages the data ranks' gradients
(``parallel.tensor``'s operators: the sum over 'model' is the identity
backward, the tokens' and the router weights' gradients are summed over
'model', the load-balance statistics' over 'data').
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..parallel import tensor as tp
from ..parallel.sharding import mesh_shape
from .config import ModelConfig
from .moe import MOE_OPTS, experts, route, shared_experts


def _local_experts(w, axis_dim: int, e_start: int, e_loc: int, data_group):
    """This model rank's experts of a weight: a DTensor's local shard
    (its ff slices gathered over 'data' where split there), or rows
    ``[e_start, e_start + e_loc)`` of a whole tensor."""
    from torch.distributed.tensor import Shard

    if not tp.is_dtensor(w):
        return w[e_start:e_start + e_loc]
    names = list(w.device_mesh.mesh_dim_names)
    if tp.model_shard_dim(w) != 0:
        raise ValueError(f"moe_block_a2a wants the experts split over 'model' (dim 0); got "
                         f"{w.placements}")
    out = w.to_local()
    data_pl = w.placements[names.index("data")] if "data" in names else None
    if isinstance(data_pl, Shard):
        out = tp.all_gather(out, axis_dim, data_group, full_len=w.shape[axis_dim],
                            kind="moe_ff_gather")
    return out


def moe_block_a2a(
    params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, mesh,
    data_axis: str = "data", model_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``moe.moe_block`` over a ``(data, model)`` ``DeviceMesh``:
    ``x`` (B_loc, T, D) is this rank's rows of the batch (the same on the
    ranks of its model group); ``params`` DTensors laid out by the rules
    (experts over 'model'), or whole tensors, of which each rank takes its
    experts.  Returns (this rank's output rows, aux), aux the same on
    every rank."""
    m = cfg.moe
    names = mesh_shape(mesh)
    model_n, data_n = names.get(model_axis, 1), names.get(data_axis, 1)
    if m.n_experts % model_n:
        raise ValueError(f"{m.n_experts} experts do not split over {model_n} model ranks")
    e_loc = m.n_experts // model_n
    dims = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    me = coord[dims.index(model_axis)] if model_axis in dims else 0
    model_group = mesh.get_group(model_axis) if model_n > 1 else None
    data_group = mesh.get_group(data_axis) if data_n > 1 else None
    e_start = me * e_loc

    B, T, D = x.shape
    S, k = B * T, m.top_k
    xf = x.reshape(S, D)
    probs, top_w, top_e = route({"router": tp.whole(params["router"])}, xf, cfg)
    # the local experts' products see every token: their gradients (and the
    # router weights', which only the local experts read) are summed over
    # 'model'
    xin = tp.copy_to(xf, model_group)
    w_in = tp.copy_to(top_w.reshape(-1), model_group)
    wg = _local_experts(params["w_gate"], 2, e_start, e_loc, data_group)
    wu = _local_experts(params["w_up"], 2, e_start, e_loc, data_group)
    wd = _local_experts(params["w_down"], 1, e_start, e_loc, data_group)

    flat_e = top_e.reshape(-1)
    local = (flat_e >= e_start) & (flat_e < e_start + e_loc)
    rel_e = torch.where(local, flat_e - e_start, e_loc)             # e_loc: the drop bin
    C = max(int(S * k * m.capacity_factor / m.n_experts) + 1, k)
    out, _, dropped = experts(xin, rel_e, w_in, e_loc, C, k, wg, wu, wd)
    out = tp.reduce_from(out.to(x.dtype), model_group)
    if MOE_OPTS["count_drops"]:
        moe_block_a2a.dropped = moe_block_a2a.dropped + dropped
    if m.n_shared:
        out = out + shared_experts(tp.whole_tree({n: params[n] for n in
                                                  ("shared_gate", "shared_up",
                                                   "shared_down")}), xf)

    # load-balance stats are global: averaged over the data shards
    mean_probs = probs.mean(dim=0)
    frac = torch.bincount(flat_e, minlength=m.n_experts) / (S * k)
    if data_group is not None:
        stats = tp.sum_both(torch.stack([mean_probs, frac.to(mean_probs.dtype)]),
                            data_group) / data_n
        mean_probs, frac = stats[0], stats[1]
    aux = m.n_experts * torch.sum(mean_probs * frac)
    return out.reshape(B, T, D), aux.float()


moe_block_a2a.dropped = 0
