"""TFRC-paced CCP: equation-based congestion control on the feedback loop.

Under the transport layer's delayed, lossy feedback channel
(:mod:`repro_torch.core.transport`), CCP's loss reaction is a multiplicative
backoff: every timeout doubles the effective TTI until a receipt resets it.
That is the right response to an *outage* but over-throttles on *burst
erasures*: a Gilbert–Elliott fade eats several packets, each doubling the
pace, when one congestion signal already carries all the information.

``tfrc_ccp`` replaces the reflexive backoff with RFC 5348 equation-based
pacing:

  * a loop-carried **loss-event-rate** estimator ``p_ev``
    (:func:`repro_torch.core.transport.tfrc.loss_event_update`): losses
    within one RTT of the first loss of an event collapse into one event;
  * the **RTT estimate** is CCP's own eq.-(4) EWMA ``rtt_data``, floored by
    the packet's scaled ACK sample as in the timeout deadline; under
    transport it tracks the *observed* feedback RTT;
  * pacing: while a loss event is open (an unbroken run of losses), the
    eq.-(8) send instant is floored by ``tx + tfrc_send_interval(p_ev,
    rtt)``; between events the floor is off (a one-packet-in-flight flow
    already sends below the TCP-fair rate there);
  * the multiplicative backoff engages only after ``outage_run``
    consecutive losses (an outage signature), as in ``adaptive_rate``; the
    line-14 retransmission deadline is kept.

With no losses ``p_ev`` stays 0, the floor is 0, and the policy is ``ccp``
bit for bit at any RTT.

Port of ``repro.core.policies.tfrc`` on a leading rep dimension (B, N).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import ccp as ccp_mod
from ..transport import tfrc as tfrc_mod
from .base import StepCtx, register
from .ccp import CCPPolicy


@register
@dataclasses.dataclass(frozen=True)
class TFRCCCPPolicy(CCPPolicy):
    """CCP paced by the TFRC throughput equation (see module docstring)."""

    name = "tfrc_ccp"
    version = 1

    loss_ewma: float = 0.1   # EWMA weight of the loss-event-rate estimate
    p_clip: float = 0.5      # cap on p_ev entering the throughput equation
    outage_run: int = 4      # consecutive losses before backoff engages

    def init(self, shape, device):
        state = super().init(shape, device)
        return dict(state, p_ev=torch.zeros(shape, device=device),
                    ev_start=torch.full(shape, -torch.inf, device=device),
                    consec=torch.zeros(shape, dtype=torch.int32, device=device))

    def _rtt_eff(self, state, ctx: StepCtx):
        """The TFRC R: CCP's EWMA feedback-RTT estimate, floored by this
        packet's scaled ACK sample (the timeout deadline's floor, so a
        helper with no receipt yet still has a finite R)."""
        return torch.maximum(state["est"].rtt_data, ctx.cfg.data_scale * ctx.rtt_ack)

    def on_computed(self, state, ctx: StepCtx):
        new = super().on_computed(state, ctx)
        # The whole p_ev update lives in on_timeout: it runs every step under
        # churn, and without churn there is no loss for p_ev to measure.
        return dict(new, consec=torch.where(ctx.received, 0, state["consec"]))

    def next_load(self, state, ctx: StepCtx) -> torch.Tensor:
        tx_ccp = super().next_load(state, ctx)
        pace = tfrc_mod.tfrc_send_interval(
            torch.minimum(state["p_ev"], ccp_mod._scalar(self.p_clip, state["p_ev"])),
            self._rtt_eff(state, ctx))
        # The floor only while a loss event is open (consec > 0); at p_ev = 0
        # it is tx itself and eq. (8) decides alone: bitwise ccp.
        pace = torch.where(state["consec"] > 0, pace, 0.0)
        return torch.maximum(tx_ccp, ctx.tx + pace)

    def on_timeout(self, state, ctx: StepCtx, tx_next):
        deadline = self._deadline(state, ctx)
        p_ev, ev_start = tfrc_mod.loss_event_update(
            state["p_ev"], state["ev_start"], ctx.lost, ctx.received, ctx.tx,
            self._rtt_eff(state, ctx), w=self.loss_ewma)
        consec = torch.where(ctx.lost, state["consec"] + 1, state["consec"])
        # The measured event rate throttles the pace; the multiplicative
        # backoff is kept for loss runs that look like an outage.
        est = ccp_mod.on_timeout(state["est"], ctx.lost & (consec >= self.outage_run),
                                 max_backoff=ctx.max_backoff)
        new = dict(state, est=est, p_ev=p_ev, ev_start=ev_start, consec=consec)
        return new, ctx.tx + deadline

    def summary(self, state) -> dict:
        return {"p_ev": state["p_ev"]}
