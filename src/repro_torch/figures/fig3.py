"""Paper Fig. 3: task completion delay vs. number of rows, Scenarios 1 & 2.

Setup: N=100 helpers, a_n=0.5, mu_n ~ U{1,2,4}, 10-20 Mbps links, 5% coding
overhead; CCP / Best / Optimum Analysis / Uncoded (mean, mu) / HCMM, every
policy row through ``Engine.run``.  T is simulated seconds, not a hardware
time.

Paper anchors: Sc.1 ~30% better than HCMM, ~24% better than uncoded;
Sc.2 ~40% / ~69%, and HCMM beats uncoded.

One deliberate difference from ``benchmarks/fig3.py``: the Optimum Analysis
column is eq. (27) over the CCP run's own helper draws
(:func:`~.common.optimum`), where the reference draws it with
``jax.random.PRNGKey(r)``, a key schedule apart from its policies'.
"""

from __future__ import annotations

from ..configs.ccp_paper import FIG3
from .common import delay_sweep

POLICIES = ("ccp", "best", "uncoded_mean", "uncoded_mu", "hcmm")
R_SWEEP = (1000, 2000, 4000, 8000)


def run(reps: int = 40, r_sweep=R_SWEEP, policies=POLICIES, *, device=None,
        seed: int = 0, out_dir=None) -> dict:
    return delay_sweep("fig3", FIG3, reps, r_sweep, policies, device=device, seed=seed,
                       out_dir=out_dir, with_optimum=True)
