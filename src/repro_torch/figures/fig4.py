"""Paper Fig. 4: delay vs. rows with mu ~ U{1,3,9}, a_n = 1/mu_n, every
policy row through ``Engine.run``.  T is simulated seconds.

Paper anchors: Sc.1 >30% over HCMM / >15% over uncoded; Sc.2 ~42% / ~73%.
"""

from __future__ import annotations

from ..configs.ccp_paper import FIG4
from .common import delay_sweep

POLICIES = ("ccp", "best", "uncoded_mean", "uncoded_mu", "hcmm")
R_SWEEP = (1000, 2000, 4000, 8000)


def run(reps: int = 40, r_sweep=R_SWEEP, policies=POLICIES, *, device=None,
        seed: int = 0, out_dir=None) -> dict:
    return delay_sweep("fig4", FIG4, reps, r_sweep, policies, device=device, seed=seed,
                       out_dir=out_dir, with_optimum=False)
