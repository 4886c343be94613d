"""Fleet-level metrics: fairness and helper utilization.

They reduce the per-(task, helper, packet) trace of a fleet rep to the
values the saturation sweep plots (``figures/fig_fleet.py``): how evenly the
tenants' sojourn times came out (Jain), and how busy each helper was inside
the rep's makespan.  The p50/p99 reductions over a batch live on the host
(``FleetRunResult.summary()``).  Port of ``repro.core.fleet.metrics``.
"""

from __future__ import annotations

import torch

from ..policies.uncoded import ordered_sum

__all__ = ["jain_fairness", "helper_utilization"]


def jain_fairness(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Jain's index ``J = (sum x)^2 / (n * sum x^2)`` over the valid
    entries of each row of ``x`` (B, T): 1.0 when every tenant saw the same
    sojourn, 1/n when one tenant took the whole delay.  NaN for a row with
    no valid entry.  The sums fold left, as the reference's XLA CPU build
    sums these short rows."""
    xv = torch.where(valid, x, 0.0)
    n = valid.sum(dim=-1)
    # The sum of squares accumulates by fused multiply-adds, as the
    # reference's fused reduction does.
    sq = xv[..., 0] * xv[..., 0]
    for j in range(1, xv.shape[-1]):
        sq = torch.addcmul(sq, xv[..., j], xv[..., j])
    den = n * sq
    return torch.where(den > 0, ordered_sum(xv) ** 2 / den, torch.nan)


def helper_utilization(beta, tr, d_down, t_end):
    """Per-helper busy fraction inside the makespan ``[0, t_end]``: the
    compute work whose *finish* (``tr - d_down`` for a delivered packet)
    landed by ``t_end``, over ``t_end``.  beta / tr / d_down are (B, T, N,
    M) fleet traces (or (B, N, M) single-task ones), t_end (B,); returns
    (B, N).  Work after the last certified completion does not count."""
    fin = tr - d_down
    t_b = t_end.reshape((-1,) + (1,) * (tr.dim() - 1))
    served = torch.where(torch.isfinite(tr) & (fin <= t_b), beta, 0.0)
    busy = served.sum(dim=(1, 3)) if served.dim() == 4 else served.sum(dim=-1)
    t_n = t_end[:, None]
    return torch.where(t_n > 0, busy / t_n, 0.0)
