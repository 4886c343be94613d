"""Model substrate: parameter init and the param tree's walkers, norms,
activations, RoPE (port of ``repro.models.common``).

Params are nested dicts of tensors with the reference's layouts.  The
reference's init draws from ``jax.random`` (threefry), which torch cannot
reproduce; :class:`ParamBuilder` draws the same distributions from a
``torch.Generator`` on a given device, so a full-size model is initialised
on the card without passing through the host.  Tests that need the
reference's exact weights load them with ``interop.lm_params_from_numpy``.
The logical sharding axes of the reference have no counterpart yet (the
port runs on one card).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in order (dict keys as
    inserted)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclasses.dataclass
class ParamBuilder:
    """Draws parameters from one generator, on its device."""

    generator: torch.Generator
    param_dtype: torch.dtype = torch.float32

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def normal(self, shape, stddev: float = 0.02) -> torch.Tensor:
        v = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return v.mul_(stddev).to(self.param_dtype)

    def fan_in(self, shape, fan_axis=0) -> torch.Tensor:
        axes = (fan_axis,) if isinstance(fan_axis, int) else tuple(fan_axis)
        fan = 1
        for ax in axes:
            fan *= shape[ax]
        return self.normal(shape, fan ** -0.5)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.param_dtype, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.param_dtype, device=self.device)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             scale_plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = scale.float()
    if scale_plus_one:  # gemma-style (1 + w)
        s = 1.0 + s
    return (y * s).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu(approximate=True)
    "relu": F.relu,
    "tanh": torch.tanh,
}


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # theta as a Python scalar: a tensor of it on the card would be a host
    # copy, and a stream sync, in every attention call.
    return 1.0 / torch.pow(theta, exponent)


@functools.lru_cache(maxsize=None)
def _freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    return rope_freqs(head_dim, theta, device)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotation angles, (B, 1, T, head_dim/2), for
    positions (B, T) or (T,): computed once and shared by q and k."""
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * _freqs(head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x (B, H, T, D) by tables from rope_tables, in fp32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, H, T, D) with D even; positions: (B, T) or (T,) absolute.
    Half-split rotation, computed in fp32."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))
