"""CCP (Algorithm 1) as a policy: eq. (8) pacing from the ring-buffered
``E[beta]`` estimate in effect at the send instant.

Port of ``repro.core.policies.ccp`` (static path; the lines 13-14
timeout/backoff reaction comes with the churn slice).  The ring gains a rep
axis, ``(B, N, RING)``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import ccp as ccp_mod
from .base import RING, Policy, StepCtx, register


@register
@dataclasses.dataclass(frozen=True)
class CCPPolicy(Policy):
    """Algorithm 1: estimated TTI with ring-buffer feedback delay."""

    name = "ccp"
    version = 1

    def init(self, shape, device):
        return dict(
            est=ccp_mod.init_state(shape, device),
            ring_tr=torch.full(tuple(shape) + (RING,), torch.inf, device=device),
            ring_tti=torch.zeros(tuple(shape) + (RING,), device=device),
        )

    def on_computed(self, state, ctx: StepCtx):
        est, _tti_i = ccp_mod.on_computed(
            state["est"], ctx.cfg, ctx.tx, ctx.tr_ok, ctx.tr_prev,
            ctx.rtt_ack, active=ctx.received,
        )
        # The rings are updated in place: the engine keeps no earlier state.
        slot = ctx.i % RING
        state["ring_tr"][..., slot] = torch.where(ctx.received, ctx.tr_ok, torch.inf)
        state["ring_tti"][..., slot] = est.e_beta
        return dict(state, est=est)

    def _select(self, state, tx):
        """E[beta] estimate in effect when planning the next send: the ring
        entry with the largest Tr among those with Tr <= tx (the latest
        information that had arrived by the current send instant).  Ties go
        to the first slot, as ``jnp.argmax`` does."""
        valid = state["ring_tr"] <= tx[..., None]
        masked = torch.where(valid, state["ring_tr"], -torch.inf)
        sel = torch.argmax(masked, dim=-1, keepdim=True)
        has = valid.any(dim=-1)
        e_beta_sel = torch.gather(state["ring_tti"], -1, sel)[..., 0]
        return has, e_beta_sel

    def next_load(self, state, ctx: StepCtx) -> torch.Tensor:
        # eq. (8), causal form: tx_{i+1} = min(Tr_i, tx_i + E[beta]),
        # scaled by the timeout backoff factor (1 when no timeouts).
        # Bootstrap: before any computed packet has returned by tx, the
        # collector has no estimate -> stop-and-wait on this packet.
        has, e_beta_sel = self._select(state, ctx.tx)
        tti_est = e_beta_sel * state["est"].tti_backoff
        return torch.where(
            has, torch.minimum(ctx.tr_ok, ctx.tx + tti_est), ctx.tr_ok
        )

    def backoff(self, state):
        return state["est"].tti_backoff
