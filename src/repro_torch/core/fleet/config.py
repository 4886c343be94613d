"""FleetConfig: the static shape of a multi-tenant fleet run.

A frozen (hashable) dataclass: everything here is structural (tenant
count, service discipline, admission rule, arrival process), while all
per-rep randomness (releases, random placement) comes from the run's
generator.  Port of ``repro.core.fleet.config``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .queues import DISCIPLINES

ARRIVALS = ("batch", "poisson", "uniform")

__all__ = ["ARRIVALS", "FleetConfig"]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Multi-tenant fleet shape.

    n_tasks:    concurrent tenants sharing the helper pool.
    discipline: per-helper service order for same-round jobs: 'fifo'
                (arrival order), 'priority' (non-preemptive, by the
                per-task priority key) or 'ps' (egalitarian processor
                sharing).  See :mod:`repro_torch.core.fleet.queues`.
    placement:  admission rule choosing which helpers each task recruits
                ('all', 'striped', 'random', 'fastest', or a custom rule
                through :func:`repro_torch.core.fleet.register_placement`).
    helpers_per_task: recruit-set size of the non-'all' placements (None:
                max(N // n_tasks, 1), a fair partition).
    arrival:    task release process: 'batch' (all at t=0), 'poisson'
                (rate ``load``) or 'uniform' (spacing 1/``load``).  Task 0
                always releases at t=0, so a 1-task fleet is the
                single-task engine.
    load:       task arrival rate in tasks/s (poisson and uniform only).
    priority:   per-task priority keys, smaller served first ('priority'
                discipline; None: the task index).
    """

    n_tasks: int = 1
    discipline: str = "fifo"
    placement: str = "all"
    helpers_per_task: Optional[int] = None
    arrival: str = "batch"
    load: float = 0.0
    priority: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if not (isinstance(self.n_tasks, int) and self.n_tasks >= 1):
            raise ValueError(f"n_tasks must be an int >= 1, got {self.n_tasks!r}")
        if self.discipline not in DISCIPLINES:
            raise ValueError(
                f"unknown discipline {self.discipline!r}; known: {DISCIPLINES}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival {self.arrival!r}; known: {ARRIVALS}")
        if self.arrival != "batch" and not self.load > 0:
            raise ValueError(
                f"arrival={self.arrival!r} needs load > 0 (tasks/sec), got {self.load!r}")
        if self.helpers_per_task is not None and self.helpers_per_task < 1:
            raise ValueError(
                f"helpers_per_task must be >= 1 or None, got {self.helpers_per_task!r}")
        if self.priority is not None:
            p = tuple(float(v) for v in self.priority)
            object.__setattr__(self, "priority", p)
            if len(p) != self.n_tasks:
                raise ValueError(
                    f"priority must have n_tasks={self.n_tasks} entries, got {len(p)}")

    def static_key(self) -> str:
        """The knob the fleet loop specializes on (``fleet_stream``'s
        ``fleet_static``)."""
        return self.discipline
