"""Beyond-paper figure: fleet saturation, tenant sojourn against offered
load.  Sojourns are simulated seconds.

The paper evaluates one master and a dedicated helper pool; an edge
deployment multiplexes *tenants* over one pool.  This sweep packs a growing
number of concurrent tasks onto a fixed pool (striped admission,
``helpers_per_task`` recruits each, wrapping into overlap once the pool is
exhausted) and records per policy:

  * p50 / p99 certified sojourn (completion minus release): the knee where
    queueing delay takes off is the pool's saturation point;
  * mean helper utilization inside the fleet makespan and the Jain fairness
    of the tenants' sojourns;
  * the uncertified-task count (dropped, never averaged).

``offered`` is the recruit-weighted load ``n_tasks * helpers_per_task /
N``: at 1.0 the striped placement runs out of disjoint helpers.  Port of
``benchmarks/fig_fleet.py``.
"""

from __future__ import annotations

import time

from ..core import engine, fleet, simulator
from .common import emit, policy_meta

N = 20
R = 300
TASK_SWEEP = (1, 2, 4, 8, 12)
HELPERS_PER_TASK = 5
POLICIES = ("ccp", "adaptive_rate", "hcmm", "naive")
DISCIPLINE = "fifo"


def run(reps: int = 40, task_sweep=TASK_SWEEP, R: int = R, n_helpers: int = N,
        helpers_per_task: int = HELPERS_PER_TASK, policies=POLICIES,
        discipline: str = DISCIPLINE, *, device=None, seed: int = 0,
        out_dir=None) -> dict:
    policies = tuple(policies)
    eng = engine.Engine(device=device)
    cfg = simulator.ScenarioConfig(N=n_helpers, scenario=1)
    h = min(helpers_per_task, n_helpers)
    t0 = time.perf_counter()
    rows, knee, walls = [], {}, {}
    for m in task_sweep:
        t_row = time.perf_counter()
        fc = fleet.FleetConfig(n_tasks=m, discipline=discipline, placement="striped",
                               helpers_per_task=h)
        row = {"n_tasks": m, "offered": m * h / n_helpers, "R": R, "N": n_helpers,
               "helpers_per_task": h}
        for pol in policies:
            res = eng.run_fleet(cfg, pol, reps, R, fleet=fc, seed=seed)
            row[pol] = dict(res.summary(), M=res.M)
            if row["offered"] >= 1.0 and pol not in knee:
                knee[pol] = row[pol]["p50"]
        rows.append(row)
        walls[m] = time.perf_counter() - t_row
    wall = time.perf_counter() - t0
    emit("fig_fleet", rows, device=eng.device, seed=seed, wall_s=wall,
         policies=policy_meta(policies), out_dir=out_dir,
         derived=" ".join(f"{pol}_knee_p50={knee[pol]:.3f}" for pol in policies if pol in knee),
         extra_meta={"discipline": discipline})
    return {"rows": rows, "knee": knee, "policies": policies, "wall_s": wall,
            "row_wall_s": walls}
