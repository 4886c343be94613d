"""AdamW + schedules + global-norm clipping (port of ``repro.optim.adamw``).

State mirrors the parameter tree (the port's nested dicts and lists of
tensors): ``{m, v}`` in fp32 on each parameter's device, and the step as a
Python int, so a step reads nothing back from the card.  The schedule's
scalars are computed in float32 as the reference computes them.

Unlike the reference's pure update, :func:`apply` updates the parameters and
the moments in place (under ``torch.no_grad``) and returns the same tensors:
at phi4-mini's width a copy of params, m and v would be 17 GB more.

Parameters that are DTensors over a ``(data, model)`` mesh (the
tensor-parallel step) take ZeRO-1: :func:`init` lays m and v out by
``parallel.sharding.opt_state_shardings`` (a parameter's largest
dimension it leaves whole split over 'data'), and :func:`apply` updates on
each rank its slice of the moments and of the parameter, then gathers the
parameter's slices over 'data'.  The gradients come whole over 'data' (the
step's all-reduce), so every slice's update is the one-process update of
those elements.  The gradient norm sums every element once over the mesh.
On a ``(pod, data, model)`` mesh the moments are split over 'data' and
alike over 'pod', as the reference's ``opt_state_shardings`` lays them out.
A parameter split over 'data' itself (FSDP) has moments laid out as it is:
each rank updates its shard, and nothing is gathered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Optional, Tuple, Union

import torch

from ..models.common import tree_leaves, tree_map
from ..parallel import tensor as tp

PyTree = Any


class AdamWState(NamedTuple):
    step: int       # updates applied so far
    m: PyTree       # fp32, like params
    v: PyTree       # fp32, like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_frac: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate at ``step``, a float32 scalar tensor on the CPU."""
    s = torch.as_tensor(step, device="cpu").to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    else:
        decay = torch.tensor(1.0)
    return cfg.lr * warm * decay


def init(params: PyTree, shardings: PyTree = None) -> AdamWState:
    """Zero moments like ``params``.  DTensor parameters get DTensor moments
    laid out by ``shardings`` (a ``(mesh, placements)`` a leaf:
    ``sharding.opt_state_shardings`` for ZeRO-1), by default as the
    parameter is."""
    def zeros(p, s=None):
        if not tp.is_dtensor(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        mesh, placements = s if s is not None else (p.device_mesh, p.placements)
        return _dzeros(p, mesh, placements)

    if shardings is None:
        return AdamWState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))
    pairs = tp.shardings_like(shardings, params)
    return AdamWState(step=0, m=tree_map(zeros, params, pairs),
                      v=tree_map(zeros, params, pairs))


def _dzeros(p, mesh, placements):
    """A zero fp32 DTensor of ``p``'s global shape laid out by ``placements``."""
    from torch.distributed.tensor import DTensor

    shape = tp.local_shape(p.shape, mesh, placements)
    return DTensor.from_local(torch.zeros(shape, dtype=torch.float32, device=p.device), mesh,
                              list(placements), run_check=False, shape=p.shape,
                              stride=tp.dense_strides(p.shape))


def leaf_sq_norms(tree: PyTree) -> List[torch.Tensor]:
    """Each leaf's sum of squares in fp32, a scalar tensor on its device
    (a DTensor's over its whole value, every element once)."""
    if tp.any_dtensor(tree):
        return tp.leaf_sq_norms(tree)
    return [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(leaf_sq_norms(tree)))


def _scalar(x: torch.Tensor) -> float:
    return float(x)  # a CPU float32 scalar: no device sync


@torch.no_grad()
def apply(
    cfg: AdamWConfig, params: PyTree, grads: PyTree, state: AdamWState,
) -> Tuple[PyTree, AdamWState, dict]:
    """One optimizer step, in place: the parameters and the moments are
    updated where they lie and returned.  Returns (params', state',
    metrics) with ``grad_norm`` (before clipping, a tensor on the grads'
    device), ``lr`` (a float32 CPU scalar) and ``grad_leaf_sq``, each
    gradient leaf's sum of squares (a 1-D tensor: finite and positive where
    the leaf is finite and not all zero)."""
    sharded = tp.any_dtensor(params)
    sq = tp.leaf_sq_norms(grads, params) if sharded else leaf_sq_norms(grads)
    gnorm = torch.sqrt(sum(sq))
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    s32 = torch.tensor(float(step), dtype=torch.float32)
    b1c = _scalar(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** s32)
    b2c = _scalar(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** s32)
    lr_f = _scalar(lr)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        if sharded:
            _update_slice(cfg, p, tp.local(g), m, v, scale, b1c, b2c, lr_f)
            continue
        g32 = g.float() if scale is None else g.float() * scale
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        del g32
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        p32 = p.float()
        if cfg.weight_decay:
            delta.add_(p32, alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta, alpha=lr_f)
        else:
            p.copy_(p32 - lr_f * delta)
        del delta, p32
    metrics = {"grad_norm": gnorm, "lr": lr, "grad_leaf_sq": torch.stack(sq)}
    return params, AdamWState(step, state.m, state.v), metrics


def _data_slice(m, p):
    """(dim, start, length, group) of the slice of its parameter ``p`` that
    a moment DTensor holds over 'data', or None when it is whole there or
    ``p`` is itself split there (FSDP: the moment's shard is ``p``'s)."""
    from torch.distributed.tensor import Shard

    if tp.data_shard_dim(p) is not None:
        return None
    names = list(m.device_mesh.mesh_dim_names or ())
    if "data" not in names:
        return None
    i = names.index("data")
    pl = m.placements[i]
    if not isinstance(pl, Shard):
        return None
    sizes = tp.chunk_sizes(m.shape[pl.dim], m.device_mesh.size(i))
    c = m.device_mesh.get_coordinate()[i]
    return pl.dim, sum(sizes[:c]), sizes[c], m.device_mesh.get_group("data")


def _update_slice(cfg, p, g, m, v, scale, b1c, b2c, lr_f) -> None:
    """ZeRO-1 update of one DTensor parameter: this rank's slice of the
    moments and of the parameter updated as the one-process update does,
    then the parameter's slices gathered over 'data'."""
    pl, ml, vl = p.to_local(), m.to_local(), v.to_local()
    cut = _data_slice(m, p)
    if cut is not None:
        dim, start, length, group = cut
        g = g.narrow(dim, start, length)
        target = pl.narrow(dim, start, length)
    else:
        target = pl
    g32 = g.float() if scale is None else g.float() * scale
    ml.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
    vl.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
    del g32
    delta = (ml / b1c).div_((vl / b2c).sqrt_().add_(cfg.eps))
    p32 = target.float()
    if cfg.weight_decay:
        delta.add_(p32, alpha=cfg.weight_decay)
    if target.dtype == torch.float32:
        target.sub_(delta, alpha=lr_f)
    else:
        target.copy_(p32 - lr_f * delta)
    del delta, p32
    if cut is not None:
        pl.copy_(tp.all_gather(target, dim, group, full_len=pl.shape[dim],
                               kind="zero1_param_gather"))
