"""Multi-tenant fleet layer: shared helpers, queues, admission, metrics.

The single-task engine (:mod:`repro_torch.core.engine`) gives each task a
dedicated pool of N helpers.  This package models T tenants *sharing* the
pool: :class:`FleetConfig` describes the fleet, :func:`fleet_stream` runs
the event-clock loop that serializes per-helper busy time across tenants
(:mod:`.queues` holds the service disciplines), :mod:`.admission` decides
who recruits whom and when tasks release, and :mod:`.metrics` reduces a
fleet trace to utilization and fairness.  Entry point:
:meth:`repro_torch.core.engine.Engine.run_fleet`.

Port of ``repro.core.fleet``: the reference's ``vmap`` over tenants is an
explicit tenant axis, traces are (B, T, N, M).
"""

from .queues import DISCIPLINES, serve_round
from .config import ARRIVALS, FleetConfig
from .admission import PLACEMENTS, draw_releases, place, register_placement
from .metrics import helper_utilization, jain_fairness
from .stream import fleet_stream

__all__ = [
    "ARRIVALS",
    "DISCIPLINES",
    "FleetConfig",
    "PLACEMENTS",
    "draw_releases",
    "fleet_stream",
    "helper_utilization",
    "jain_fairness",
    "place",
    "register_placement",
    "serve_round",
]
