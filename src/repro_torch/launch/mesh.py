"""Meshes of the port: a grid of torch devices, and the ranks' process group.

Port of ``repro.launch.mesh``.  The reference shards in one controller,
with ``shard_map`` over a ``jax`` mesh of local devices.  The port splits
that by whether a path has a collective:

- Paths with no collective run in one process over a :class:`HostMesh`, a
  ``(data, model)`` grid of torch devices with the reference's axis names:
  ``core.coded_matmul.run(mesh=...)`` (each shard's coded blocks on its
  device, the results concatenated) and ``Engine(shard=True)`` /
  ``run_fleet(shard=True)`` (per-rep lanes never communicate).
- Paths with a collective run as ``torch.distributed`` ranks, one process
  each, started by ``torchrun`` or :func:`spawn_ranks`: ``coded_psum``,
  the data-parallel gradient mean and ``sharded_cross_entropy``
  (:mod:`repro_torch.parallel.collectives`), and the tensor-parallel LM
  over a ``(data, model)`` ``DeviceMesh`` of ranks (:func:`make_device_mesh`,
  :mod:`repro_torch.parallel.tensor`).  :func:`init_ranks` starts their
  process group; :func:`backend_for` picks its backend.

Run the ranks on the CPU (gloo) or on cards::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch phi4-mini-3.8b --mesh 4,1 --coded-dp ...
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import _device

__all__ = ["HostMesh", "backend_for", "init_ranks", "make_device_mesh", "make_host_mesh",
           "make_production_mesh", "rank_device", "spawn_ranks"]


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """A grid of torch devices with named axes: ``devices`` is a numpy
    object array of ``torch.device`` whose shape follows ``axis_names``, as
    a ``jax.sharding.Mesh``'s does.  A device may appear more than once
    (``make_host_mesh(model=8, devices=["cuda:0"] * 8)``: eight shards'
    launches on one card)."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])


def _local_devices() -> List[torch.device]:
    dev = _device.resolve()  # the card, or a RuntimeError naming device='cpu'
    return [torch.device(dev.type, i) for i in range(torch.cuda.device_count())]


def make_host_mesh(data: int = 1, model: int = 1, devices: Optional[Sequence] = None) -> HostMesh:
    """A ``(data, model)`` mesh.  ``devices=None`` takes the first
    ``data * model`` distinct local cards and raises when there are fewer,
    as ``jax.make_mesh`` does (and without a card, as every entry point
    does); ``devices`` given (strings or ``torch.device``, repeats allowed)
    must hold exactly ``data * model`` of them, placed row-major."""
    n = int(data) * int(model)
    if devices is None:
        have = _local_devices()
        if len(have) < n:
            raise ValueError(f"a {data}x{model} mesh needs {n} distinct devices; this host has "
                             f"{len(have)} ({[str(d) for d in have]}); pass devices=[...] to "
                             "place several shards on one device")
        devs = have[:n]
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a {data}x{model} mesh needs {n} devices, got {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return HostMesh(grid.reshape(int(data), int(model)), ("data", "model"))


def make_device_mesh(data: int, model: int = 1, ranks: Optional[Sequence[int]] = None):
    """A ``(data, model)`` ``torch.distributed`` ``DeviceMesh`` over ranks
    of the started process group (:func:`init_ranks`), with the reference's
    axis names: ``ranks`` (default ``0 .. data * model - 1``; the first
    ``data * model`` of them are taken) placed row-major, rank
    ``ranks[d * model + m]`` at (d, m).  Every rank of the world must call
    it, those left out of the mesh too: they take part in creating its
    groups (their coordinate is then None).  The mesh's device type is
    the ranks' (``cuda`` once :func:`init_ranks` has set this rank's card,
    else ``cpu``)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = int(data) * int(model)
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks][:n]
    if len(ranks) != n:
        raise ValueError(f"a {data}x{model} mesh needs {n} ranks, got {len(ranks)}")
    if n > dist.get_world_size():
        raise ValueError(f"a {data}x{model} mesh needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    kind = "cuda" if torch.cuda.is_available() and torch.cuda.is_initialized() else "cpu"
    return DeviceMesh(kind, torch.tensor(ranks, dtype=torch.int64).reshape(int(data), int(model)),
                      mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (data=16, model=16) pod, or (pod=2, 16, 16): only the
    dry run lowers onto it, and the dry run waits for slice C6 of the port."""
    raise NotImplementedError(
        "make_production_mesh serves the dry run (launch/dryrun), which waits for slice C6 of "
        "the port; make_host_mesh builds a mesh of local devices")


def backend_for(device, world_size: int) -> str:
    """The process group's backend for ranks given ``device``, as
    :func:`rank_device` places them: gloo for ranks on the CPU; NCCL only
    when each local rank gets a card of its own (``device`` without an
    index, and at least ``LOCAL_WORLD_SIZE`` cards); else gloo with CUDA
    tensors, since NCCL refuses two ranks on one device.  A device with an
    index puts every local rank on that card."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device.index is not None:
        return "gloo" if local > 1 else "nccl"
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def init_ranks(rank: Optional[int] = None, world_size: Optional[int] = None, *,
               device=None, store_path: Optional[str] = None, backend: Optional[str] = None,
               timeout_s: float = 300.0):
    """Start this rank's process group and return its world group (the
    data group of ``--mesh D,1``; :func:`make_device_mesh` lays a
    ``(data, model)`` mesh over it).

    ``rank`` and ``world_size`` default to ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE``; the rendezvous is a ``FileStore`` at ``store_path``
    when given (a file that does not exist yet, shared by the ranks), else
    ``torchrun``'s ``env://``.  ``device`` (default ``cuda``; raises
    without a card unless ``cpu``) is this rank's device: ranks on cards
    take card ``LOCAL_RANK % device_count``.  ``backend`` defaults to
    :func:`backend_for`'s choice, which rank 0 prints.  Every collective of
    the group fails after ``timeout_s`` instead of hanging."""
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    dev = rank_device(device, rank)
    if backend is None:
        backend = backend_for(_device.resolve(device), world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is not None:
        store = dist.FileStore(str(store_path), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size, timeout=timeout)
    if rank == 0:
        print(f"[ranks] world_size={world_size} backend={backend} device={dev}", flush=True)
    return dist.group.WORLD


def rank_device(device, rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``LOCAL_RANK % device_count``
    (``LOCAL_RANK`` defaults to ``rank``) of ``device``'s type."""
    dev = _device.resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _rank_entry(rank: int, fn: Callable, world_size: int, workdir: str) -> None:
    torch.set_num_threads(1)
    args = torch.load(Path(workdir) / "args.pt", weights_only=False)
    out = fn(rank, world_size, str(Path(workdir) / "store"), *args)
    torch.save(out, Path(workdir) / f"rank{rank}.pt")


def spawn_ranks(fn: Callable, world_size: int, *args, timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, store_path, *args)`` in ``world_size``
    spawned processes, one torch thread each, and return each rank's
    return value (saved with ``torch.save``, loaded on the CPU), rank
    order.  ``args`` reach the ranks through a file (``torch.save``), so
    they may be large.  ``store_path`` names a fresh file for :func:`init_ranks`'s
    ``FileStore``.  ``fn`` must be importable by name (a module-level
    function).  A rank that raises fails the call with its traceback; past
    ``timeout_s`` every rank is killed and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks-") as workdir:
        # The arguments go through a file: through the spawn pipe, a large
        # one would hold each start until the rank before had imported fn.
        torch.save(args, Path(workdir) / "args.pt")
        ctx = mp.start_processes(_rank_entry, args=(fn, world_size, workdir),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks of {getattr(fn, '__name__', fn)} "
                                       f"did not finish in {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(Path(workdir) / f"rank{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(world_size)]
