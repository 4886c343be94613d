"""Paper §6 efficiency table: measured vs. theoretical (eq. 12) helper
efficiency at R=8000 (mu ~ U{1,3,9}, a=1/mu).

Anchors: measured ~99.7% (Sc.1) / ~99.9% (Sc.2); theory ~99.4%;
measured >= theory (theory is the average-analysis lower curve).
"""

from __future__ import annotations

import time

import numpy as np

from ..configs.ccp_paper import FIG4
from ..core import engine, theory
from .common import certified, emit, policy_meta


def run(reps: int = 20, R: int = 8000, policy: str = "ccp", *, device=None,
        seed: int = 0, out_dir=None) -> dict:
    eng = engine.Engine(device=device)
    t0 = time.perf_counter()
    rows = []
    for sc in (1, 2):
        out = eng.run(FIG4[sc], policy, reps, R, seed=seed)
        valid = certified(out, "efficiency")
        eff = float(np.nanmean(out.efficiency.cpu().numpy()[valid]))
        rate, a, mu = (t.cpu().numpy()[valid].reshape(-1) for t in (out.rate, out.a, out.mu))
        theo = float(np.mean(theory.efficiency((8.0 * R + 8.0) / rate, a, mu)))
        rows.append({"scenario": sc, "measured": eff, "theory_eq12": theo,
                     "invalid": int((~valid).sum())})
    wall = time.perf_counter() - t0
    emit("efficiency", rows, device=eng.device, seed=seed, wall_s=wall,
         policies=policy_meta((policy,)), out_dir=out_dir,
         derived=";".join(f"sc{r['scenario']}_meas={r['measured']:.4f},"
                          f"theory={r['theory_eq12']:.4f}" for r in rows))
    return {"rows": rows, "wall_s": wall}
