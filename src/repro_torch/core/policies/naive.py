"""Naive stop-and-wait (paper eq. 16), static or oracle ARQ timer.

``naive``: tx_{i+1} = Tr_i, and, under churn, a retransmission timer
statically provisioned for the slowest helper class (Naive has no
estimator, so it cannot adapt the timer per helper).

``naive_oracle``: the same stop-and-wait stream with a per-helper *oracle*
timer built from the true mean runtime and link rate.

Port of ``repro.core.policies.naive``.  The timer fires only under churn
(``on_timeout``); on the static path no packet is lost.
"""

from __future__ import annotations

import dataclasses

from .. import ccp as ccp_mod
from ..simulator import _rdiv  # num / t as one float32 division, as the reference
from .base import Policy, StepCtx, register


@dataclasses.dataclass(frozen=True)
class NaivePolicy(Policy):
    oracle: bool = False
    version = 1

    @property
    def name(self) -> str:
        return "naive_oracle" if self.oracle else "naive"

    def prepare(self, cfg, R: int, ccp_cfg, mu, a, rate) -> dict:
        rtt = _rdiv(ccp_cfg.Bx + ccp_cfg.Br, rate)
        if self.oracle:
            # Oracle timer: the true per-helper mean runtime + data RTT.
            to = ccp_mod.arq_timeout(a + _rdiv(1.0, mu), rtt)
        else:
            mu_min = min(cfg.mu_choices)
            a_max = (cfg.a_const if cfg.a_mode == "const" else 1.0 / mu_min)
            to = ccp_mod.arq_timeout(a_max + 1.0 / mu_min, rtt)
        return {"naive_to": to}

    def next_load(self, state, ctx: StepCtx):
        return ctx.tr_ok

    def on_timeout(self, state, ctx: StepCtx, tx_next):
        # Stop-and-wait ARQ: retransmit when the fixed timer expires.
        return state, ctx.tx + ctx.aux["naive_to"]


register("naive", factory=NaivePolicy)
register("naive_oracle", factory=lambda: NaivePolicy(oracle=True))
