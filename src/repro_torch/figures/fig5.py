"""Paper Fig. 5: CCP vs. Best and Naive on slow links (0.1-0.2 Mbps, N=10).
T is simulated seconds.

Anchor: T_naive - T_ccp grows with R; T_ccp - T_best stays small/flat.
"""

from __future__ import annotations

import time

from ..configs.ccp_paper import FIG5
from ..core import engine
from .common import emit, mc_policy, policy_meta

POLICIES = ("ccp", "best", "naive")
R_SWEEP = (200, 400, 800, 1600)


def run(reps: int = 30, r_sweep=R_SWEEP, policies=POLICIES, *, device=None,
        seed: int = 0, out_dir=None) -> dict:
    policies = tuple(policies)
    eng = engine.Engine(device=device)
    t0 = time.perf_counter()
    rows = []
    for R in r_sweep:
        row = {"R": R}
        for p in policies:
            row[p], _ = mc_policy(eng, FIG5, R, reps, p, seed)
        if {"ccp", "best", "naive"} <= set(policies):
            row["gap_naive"] = row["naive"]["mean"] - row["ccp"]["mean"]
            row["gap_best"] = row["ccp"]["mean"] - row["best"]["mean"]
        rows.append(row)
    wall = time.perf_counter() - t0
    out = {"rows": rows, "wall_s": wall}
    derived = ""
    if "gap_naive" in rows[0]:
        out["naive_gap_growth"] = rows[-1]["gap_naive"] / max(rows[0]["gap_naive"], 1e-9)
        out["best_gap_growth"] = rows[-1]["gap_best"] / max(rows[0]["gap_best"], 1e-9)
        derived = (f"naive_gap_growth={out['naive_gap_growth']:.2f};"
                   f"best_gap_growth={out['best_gap_growth']:.2f}")
    emit("fig5", rows, device=eng.device, seed=seed, wall_s=wall,
         policies=policy_meta(policies), out_dir=out_dir, derived=derived)
    return out
