"""Admission control: which helpers each tenant recruits, and when tasks
release.

A placement rule maps ``(gen, fleet, cfg, mu, a, rate)`` (helper draws
(B, N), the run's generator) to a (B, T, N) bool recruit mask: task t's
stream to helper n exists iff ``recruit[b, t, n]`` (a stream that is not
recruited never sends: its tx stays +inf, the engine's stopped-stream
sentinel).  Rules are registered by name:

    @fleet.register_placement("my_rule")
    def my_rule(gen, fleet, cfg, mu, a, rate):
        return recruit_mask  # (B, n_tasks, cfg.N) bool

Built-ins: ``all`` (every tenant recruits the whole pool), ``striped``
(contiguous blocks of ``helpers_per_task``, disjoint while they fit),
``random`` (an independent uniform recruit set per tenant) and ``fastest``
(every tenant chases the same top helpers by expected service rate
``1/E[beta] = 1/(a + 1/mu)``).

Port of ``repro.core.fleet.admission``; draws come from the run's
``torch.Generator`` (in distribution the reference's, not its bits).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..simulator import _rdiv

__all__ = ["PLACEMENTS", "register_placement", "place", "draw_releases"]

PLACEMENTS: Dict[str, Callable] = {}


def register_placement(name: str, fn: Callable = None):
    """Register a placement rule under ``name`` (usable as a decorator)."""
    if fn is None:
        return lambda f: register_placement(name, f)
    PLACEMENTS[name] = fn
    return fn


def _h_eff(fleet, n: int) -> int:
    """Recruit-set size: ``helpers_per_task`` or a fair partition of the
    pool, never below 1 nor above N."""
    h = fleet.helpers_per_task
    if h is None:
        h = max(n // fleet.n_tasks, 1)
    return min(h, n)


def _mask_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(..., h) helper indices -> (..., n) bool mask."""
    out = torch.zeros(idx.shape[:-1] + (n,), dtype=torch.bool, device=idx.device)
    return out.scatter(-1, idx, True)


@register_placement("all")
def _place_all(gen, fleet, cfg, mu, a, rate):
    return torch.ones((mu.shape[0], fleet.n_tasks, cfg.N), dtype=torch.bool, device=mu.device)


@register_placement("striped")
def _place_striped(gen, fleet, cfg, mu, a, rate):
    """Task t recruits the h contiguous helpers from t*h (mod N): disjoint
    pools while ``n_tasks * h <= N``, wrapping into overlap beyond."""
    n, h = cfg.N, _h_eff(fleet, cfg.N)
    t_idx = torch.arange(fleet.n_tasks, device=mu.device)[:, None]
    rows = _mask_rows((t_idx * h + torch.arange(h, device=mu.device)) % n, n)
    return rows.expand(mu.shape[0], -1, -1)


@register_placement("random")
def _place_random(gen, fleet, cfg, mu, a, rate):
    n, h = cfg.N, _h_eff(fleet, cfg.N)
    keys = torch.rand((mu.shape[0], fleet.n_tasks, n), generator=gen, device=mu.device)
    return _mask_rows(torch.argsort(keys, dim=-1)[..., :h], n)


@register_placement("fastest")
def _place_fastest(gen, fleet, cfg, mu, a, rate):
    n, h = cfg.N, _h_eff(fleet, cfg.N)
    w = _rdiv(1.0, a + _rdiv(1.0, mu))  # expected service rate 1/E[beta]
    row = _mask_rows(torch.argsort(-w, dim=-1, stable=True)[..., :h], n)
    return row[:, None].expand(-1, fleet.n_tasks, -1)


def place(gen, fleet, cfg, mu, a, rate):
    """Resolve the fleet's placement rule and priority keys.

    Returns ``(recruit, prio)``: recruit (B, T, N) bool, prio (B, T)
    float32 (smaller is served first under the 'priority' discipline).
    Unknown rules raise with the known list."""
    if fleet.placement not in PLACEMENTS:
        raise ValueError(
            f"unknown placement {fleet.placement!r}; known: "
            f"{sorted(PLACEMENTS)} (register_placement adds custom rules)")
    recruit = PLACEMENTS[fleet.placement](gen, fleet, cfg, mu, a, rate)
    if fleet.priority is not None:
        prio = torch.tensor(fleet.priority, dtype=torch.float32, device=mu.device)
    else:
        prio = torch.arange(fleet.n_tasks, dtype=torch.float32, device=mu.device)
    return recruit, prio.expand(mu.shape[0], -1)


def draw_releases(gen, fleet, reps: int) -> torch.Tensor:
    """(B, T) float32 task release times under ``fleet.arrival``.  Task 0
    always releases at t=0; 'uniform' spaces tasks 1/load apart, 'poisson'
    draws exponential inter-arrivals at rate ``load``."""
    dev = gen.device
    T = fleet.n_tasks
    if fleet.arrival == "batch":
        return torch.zeros((reps, T), device=dev)
    # Divide by a tensor: a float32 CUDA tensor divided by a Python scalar is
    # a multiplication by its reciprocal.
    load = torch.full((reps, T), float(fleet.load), device=dev)
    if fleet.arrival == "uniform":
        return torch.arange(T, dtype=torch.float32, device=dev).expand(reps, T) / load
    gaps = torch.empty((reps, T), device=dev).exponential_(generator=gen) / load
    return torch.cat([torch.zeros((reps, 1), device=dev),
                      torch.cumsum(gaps[:, 1:], dim=-1)], dim=-1)
