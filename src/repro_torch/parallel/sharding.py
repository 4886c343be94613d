"""The data mesh and the batch spec (port of ``data_mesh`` and
``batch_spec`` of ``repro.parallel.sharding``).

A spec is a tuple with one entry per dimension: a mesh axis name, a tuple
of names, or None (replicated), as a ``jax.sharding.PartitionSpec`` reads.
The reference's logical-axis rules (``make_rules``, ``spec_for_axes``,
``param_shardings``, ``opt_state_shardings``, ``cache_shardings``) shard
the LM over a model axis; they wait for slice C5b of the port (DTensor).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..launch.mesh import HostMesh, _local_devices

__all__ = ["batch_spec", "data_mesh"]


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def data_mesh(devices: Optional[Sequence] = None) -> HostMesh:
    """1-D 'data' mesh over the given devices (default: every local card;
    raises without one).

    The Monte-Carlo engine's device-sharded batch runner
    (``core.engine.Engine(shard=True)``) splits its reps over it."""
    import torch

    devs = [torch.device(d) for d in devices] if devices is not None else _local_devices()
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return HostMesh(grid, ("data",))


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> tuple:
    """Shard the leading batch dim over ('pod','data') as divisibility
    allows; remaining dims replicated."""
    names = dict(zip(mesh.axis_names, mesh.devices.shape))
    axes = []
    if "pod" in names and "data" in names:
        if _div(batch, names["pod"] * names["data"]):
            axes = ["pod", "data"]
        elif _div(batch, names["data"]):
            axes = ["data"]
    elif "data" in names and _div(batch, names["data"]):
        axes = ["data"]
    # Normalize: a single mesh axis is a bare name, multiple axes a tuple:
    # consumers index bspec[0] and expect the bare-name form for one axis.
    first = None if not axes else axes[0] if len(axes) == 1 else tuple(axes)
    return (first, *([None] * extra_dims))
