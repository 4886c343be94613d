"""CCP (Algorithm 1) as a policy: eq. (8) pacing from the ring-buffered
``E[beta]`` estimate in effect at the send instant, and — under churn —
the lines 13-14 timeout/backoff reaction.

Port of ``repro.core.policies.ccp``.  The ring gains a rep axis,
``(B, N, RING)``.
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

    def _tti_scale(self, state, ctx: StepCtx):
        """Multiplier on the estimated TTI (None = 1); the adaptive-rate
        subclass compensates the measured loss rate here."""
        return None

    def next_load(self, state, ctx: StepCtx) -> torch.Tensor:
        # eq. (8), causal form: tx_{i+1} = min(Tr_i, tx_i + E[beta]),
        # scaled by the timeout backoff factor (1 when no timeouts).
        # Bootstrap: before any computed packet has returned by tx, the
        # collector has no estimate -> stop-and-wait on this packet.
        has, e_beta_sel = self._select(state, ctx.tx)
        tti_est = e_beta_sel * state["est"].tti_backoff
        scale = self._tti_scale(state, ctx)
        if scale is None:
            t_next = ctx.tx + tti_est
        else:
            # tx + tti_est * scale rounded once: the reference's XLA CPU
            # build contracts it into a fused multiply-add.
            t_next = torch.addcmul(ctx.tx, tti_est, scale)
        return torch.where(has, torch.minimum(ctx.tr_ok, t_next), ctx.tr_ok)

    def _deadline(self, state, ctx: StepCtx):
        """Alg. 1 line 14 loss-detection latency: TO = 2*(TTI + RTT^data)
        with the *pre-doubling* TTI.  ``rtt_eff`` floors the RTT term with
        this packet's scaled ACK sample so helpers that never responded
        yet still have a finite deadline.  Reads the rings ``on_computed``
        updated in place this step, as the reference's reads its new ones."""
        est = state["est"]
        has, e_beta_sel = self._select(state, ctx.tx)
        rtt_eff = torch.maximum(est.rtt_data, ctx.cfg.data_scale * ctx.rtt_ack)
        tti_pre = torch.where(has, e_beta_sel, rtt_eff) * est.tti_backoff
        return ccp_mod.timeout_deadline(est.replace(rtt_data=rtt_eff), tti_pre)

    def on_timeout(self, state, ctx: StepCtx, tx_next):
        # Alg. 1 lines 13-14 for a lost packet: the loss is detected when
        # TO elapses, the stream resumes then, and the backoff doubles
        # (capped) for the following sends.  Consecutive losses space out
        # geometrically and a receipt (on_computed) resets the backoff, so
        # a helper that rejoins is re-ramped.
        deadline = self._deadline(state, ctx)
        est = ccp_mod.on_timeout(state["est"], ctx.lost, max_backoff=ctx.max_backoff)
        return dict(state, est=est), ctx.tx + deadline

    def backoff(self, state):
        return state["est"].tti_backoff
