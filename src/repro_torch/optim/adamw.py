"""AdamW + schedules + global-norm clipping (port of ``repro.optim.adamw``).

State mirrors the parameter tree (the port's nested dicts and lists of
tensors): ``{m, v}`` in fp32 on each parameter's device, and the step as a
Python int, so a step reads nothing back from the card.  The schedule's
scalars are computed in float32 as the reference computes them.

Unlike the reference's pure update, :func:`apply` updates the parameters and
the moments in place (under ``torch.no_grad``) and returns the same tensors:
at phi4-mini's width a copy of params, m and v would be 17 GB more.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Optional, Tuple, Union

import torch

from ..models.common import tree_leaves, tree_map

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


def init(params: PyTree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))


def leaf_sq_norms(tree: PyTree) -> List[torch.Tensor]:
    """Each leaf's sum of squares in fp32, a scalar tensor on its device."""
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
    sq = leaf_sq_norms(grads)
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
