"""Elastic runtime: failure -> mesh shrink -> reshard-restore, across
``torch.distributed`` ranks (port of ``repro.runtime.elastic``).

The CCP timeout ladder (Alg. 1 l.13-14) feeds this layer: a worker whose
backoff crosses the drop threshold is declared dead, the runtime rebuilds a
``(data, model)`` mesh over the surviving ranks, restores the latest
checkpoint onto the new layout (``checkpoint.restore`` onto DTensor
targets reshards: every rank reads each leaf whole and keeps its chunk),
and training resumes; re-admission grows the mesh back the same way.

A failed device is simulated as a rank that leaves the mesh: it stays in
the process group (``DeviceMesh`` creation is collective over the world,
so it takes part in creating every later mesh's groups) and otherwise
idles.  Every rank runs the same driver calls (``rebuild``,
``fail_device``, ``run``); a rank outside the mesh returns from ``run``
with no losses.

In-step tolerance (no restart) is the coded gradient aggregation in
``runtime/train_loop.py``; this module handles the slower path when
capacity actually changes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch.distributed as dist

from .. import checkpoint as ckpt_mod
from ..core.scheduler import CCPScheduler
from ..launch.mesh import make_device_mesh


def submesh(ranks: Sequence[int], data: int, model: int):
    """A (data, model) ``DeviceMesh`` over the first ``data * model`` of
    ``ranks`` (every rank of the world calls)."""
    return make_device_mesh(data, model, list(ranks)[:data * model])


@dataclasses.dataclass
class ElasticConfig:
    ckpt_dir: str
    ckpt_every: int = 20
    min_data: int = 1


class ElasticTrainer:
    """Drives train/fail/shrink/restore cycles on every rank of the world.

    ``build`` is a factory: (mesh) -> (state, step_fn, shardings) where
    state = (params, opt_state), DTensors on the mesh; it is re-invoked
    after every topology change, on the ranks of the new mesh, so the
    layouts always match the current mesh.  ``ranks`` (default: the
    world's) play the reference's devices: ``fail_device(i)`` drops
    ``ranks[i]``."""

    def __init__(self, cfg: ElasticConfig, build: Callable,
                 ranks: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.build = build
        self.ranks = list(ranks if ranks is not None else range(dist.get_world_size()))
        self.failed: set[int] = set()
        self.ckpt = ckpt_mod.AsyncCheckpointer(cfg.ckpt_dir)
        self.step = 0
        self.mesh = None
        self.state = None
        self.step_fn = None
        self.shardings = None
        self.scheduler: Optional[CCPScheduler] = None

    # -- topology ----------------------------------------------------------

    def alive(self) -> List[int]:
        return [r for i, r in enumerate(self.ranks) if i not in self.failed]

    def in_mesh(self) -> bool:
        """Whether this rank is in the current mesh."""
        return self.mesh is not None and self.mesh.get_coordinate() is not None

    def _shape_for(self, n: int, model: int):
        data = max(n // model, self.cfg.min_data)
        return data, model

    def rebuild(self, model_axis: int) -> None:
        """A mesh over the live ranks; its ranks build their state and
        restore the latest checkpoint onto it (every rank must call)."""
        alive = self.alive()
        data, model = self._shape_for(len(alive), model_axis)
        self.ckpt.wait()
        dist.barrier()  # the writer's last checkpoint is on disk for every rank
        self.mesh = submesh(alive, data, model)
        self.scheduler = CCPScheduler(n_workers=data)
        if not self.in_mesh():
            self.state = self.step_fn = self.shardings = None
            return
        self.state, self.step_fn, self.shardings = self.build(self.mesh)
        if ckpt_mod.latest_step(self.cfg.ckpt_dir) is not None:
            # the built state's DTensors are the targets: their layouts on the
            # new mesh are the reference's shardings
            self.state, meta = ckpt_mod.restore(self.cfg.ckpt_dir, None, self.state)
            self.step = int(meta.get("step", self.step))

    # -- events ------------------------------------------------------------

    def fail_device(self, idx: int, model_axis: int) -> None:
        """Simulated hard failure of ``ranks[idx]``: the checkpoint is the
        recovery point."""
        self.ckpt.wait()
        self.failed.add(idx)
        self.rebuild(model_axis)

    def recover_device(self, idx: int, model_axis: int) -> None:
        self.failed.discard(idx)
        self.rebuild(model_axis)

    # -- training ----------------------------------------------------------

    def run(self, n_steps: int, batch_fn: Callable) -> List[float]:
        """``n_steps`` steps on the mesh (a checkpoint every ``ckpt_every``,
        in the background); a rank outside the mesh idles and returns []."""
        if not self.in_mesh():
            return []
        losses = []
        for _ in range(n_steps):
            batch = batch_fn(self.step, self.mesh)
            self.state, metrics = self.step_fn(self.state, batch)
            losses.append(float(metrics["loss"]))
            self.step += 1
            if self.step % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(self.step, self.state, metadata={"step": self.step})
        self.ckpt.wait()
        return losses
