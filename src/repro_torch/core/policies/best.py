"""Best (genie) policy: oracle TTI_{n,i} = beta_{n,i} (paper eq. 13)."""

from __future__ import annotations

import dataclasses

from .base import Policy, StepCtx, register


@register
@dataclasses.dataclass(frozen=True)
class BestPolicy(Policy):
    """Oracle pacing: the collector magically knows each packet's runtime,
    so the next send lands exactly when the helper frees up."""

    name = "best"
    version = 1

    def next_load(self, state, ctx: StepCtx):
        return ctx.tx + ctx.beta
