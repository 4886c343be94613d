"""Model substrate: parameter init and the param tree's walkers, norms,
activations, RoPE (port of ``repro.models.common``).

Params are nested dicts of tensors with the reference's layouts.  The
reference's init draws from ``jax.random`` (threefry), which torch cannot
reproduce; :class:`ParamBuilder` draws the same distributions from a
``torch.Generator`` on a given device, so a full-size model is initialised
on the card without passing through the host.  Tests that need the
reference's exact weights load them with ``interop.lm_params_from_numpy``.

Every draw also takes the leaf's logical axis names (``("embed", "heads",
"head_dim")``), the reference's, which the builder records beside the
value: :meth:`ParamBuilder.axes_of` gives the axes tree of a parameter
tree it built, and ``parallel.sharding`` maps those names to the
``(data, model)`` mesh.  A builder without a generator draws nothing: its
leaves lie on the ``meta`` device (the axes and shapes of a model at no
cost).
"""

from __future__ import annotations

import dataclasses
import functools
import math
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
    ``rest``), keeping its structure (dicts, lists, tuples, NamedTuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)


Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass
class ParamBuilder:
    """Draws parameters from one generator, on its device, and records each
    leaf's logical axes (``axes``, one name or None a dimension; omitted,
    every dimension is None).  ``generator=None``: no draws, every leaf an
    empty tensor on the ``meta`` device."""

    generator: Optional[torch.Generator]
    param_dtype: torch.dtype = torch.float32
    _axes: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return torch.device("meta") if self.generator is None else self.generator.device

    def _leaf(self, v: torch.Tensor, axes: Optional[Axes]) -> torch.Tensor:
        axes = (None,) * v.dim() if axes is None else tuple(axes)
        if len(axes) != v.dim():
            raise ValueError(f"axes {axes} for a leaf of shape {tuple(v.shape)}")
        self._axes[id(v)] = (v, axes)  # the value is held so its id stays its own
        return v

    def axes_of(self, tree: PyTree) -> PyTree:
        """The logical axes of every leaf of ``tree``, built by this builder."""
        return tree_map(lambda v: self._axes[id(v)][1], tree)

    def normal(self, shape, axes: Optional[Axes] = None, stddev: float = 0.02) -> torch.Tensor:
        if self.generator is None:
            return self._leaf(torch.empty(shape, dtype=self.param_dtype, device="meta"), axes)
        v = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return self._leaf(v.mul_(stddev).to(self.param_dtype), axes)

    def fan_in(self, shape, axes: Optional[Axes] = None, fan_axis=0) -> torch.Tensor:
        dims = (fan_axis,) if isinstance(fan_axis, int) else tuple(fan_axis)
        fan = 1
        for ax in dims:
            fan *= shape[ax]
        return self.normal(shape, axes, fan ** -0.5)

    def zeros(self, shape, axes: Optional[Axes] = None) -> torch.Tensor:
        return self._leaf(torch.zeros(shape, dtype=self.param_dtype, device=self.device), axes)

    def ones(self, shape, axes: Optional[Axes] = None) -> torch.Tensor:
        return self._leaf(torch.ones(shape, dtype=self.param_dtype, device=self.device), axes)

    def const(self, value, axes: Optional[Axes] = None) -> torch.Tensor:
        """A fixed value (no draw), in the param dtype on the device."""
        return self._leaf(torch.as_tensor(value).to(device=self.device, dtype=self.param_dtype),
                          axes)


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
    positions (B, T) or (T,): computed once and shared by q and k.  The
    frequencies are a table made once a device (for fake tensors, a
    shape-only step's, at each call: a cached fake would outlive its mode)
    and never counted in ``utils.trace``."""
    from torch._subclasses.fake_tensor import FakeTensor

    from ..utils import trace

    if positions.dim() == 1:
        positions = positions[None, :]
    with trace.uncounted():
        freqs = (rope_freqs(head_dim, theta, positions.device)
                 if isinstance(positions, FakeTensor) else _freqs(head_dim, theta,
                                                                  positions.device))
    ang = positions[:, None, :, None].float() * freqs
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


def sinusoidal_positions(t: int, d: int, max_ts: float = 10000.0,
                         device=None) -> torch.Tensor:
    """Classic sin/cos table (whisper encoder): (t, d) float32."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(max_ts)
                    * torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    pe = torch.zeros((t, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe
