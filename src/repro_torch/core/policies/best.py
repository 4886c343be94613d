"""Best (genie) policy: oracle TTI_{n,i} = beta_{n,i} (paper eq. 13)."""

from __future__ import annotations

import dataclasses

from .base import Policy, StepCtx, register


@register
@dataclasses.dataclass(frozen=True)
class BestPolicy(Policy):
    """Oracle pacing: the collector magically knows each packet's runtime,
    so the next send lands exactly when the helper frees up.  Under churn
    the oracle keeps its pacing (a lost packet costs its runtime slot but
    triggers no timeout stall): the lower envelope the adaptive policies
    are measured against."""

    name = "best"
    version = 1

    def next_load(self, state, ctx: StepCtx):
        return ctx.tx + ctx.beta

    def on_timeout(self, state, ctx: StepCtx, tx_next):
        return state, ctx.tx + ctx.beta
