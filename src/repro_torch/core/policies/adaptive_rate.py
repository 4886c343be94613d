"""Code-rate adaptation under churn (arXiv:2103.04247-style).

CCP reacts to every lost packet as if the helper had stalled: the Alg. 1
line-13 backoff doubles the effective TTI, which is right for outages but
wasteful under *channel erasures* — with a rateless fountain code a lost
packet needs no retransmission, just one more coded packet, so the right
response to a measured loss rate ``p`` is to raise the sending overhead by
``1/(1-p)`` and keep the pipeline full.

``adaptive_rate`` extends :class:`~.ccp.CCPPolicy` with an EWMA estimate
``p_hat`` of the per-helper loss process:

  * **pacing** — the eq. (8) TTI is scaled by ``(1 - min(p_hat, p_clip))``,
    so the *useful* delivery rate stays matched to the service rate;
  * **loss discrimination** — the multiplicative timeout backoff engages
    only after ``outage_run`` *consecutive* losses (an outage); isolated
    and bursty erasures pay the detection deadline but never the
    exponential stall.  A receipt still resets the backoff.

``adaptive_rate_fb`` (``decoder_feedback=True``) also runs the incremental
peeling decoder in the loop, stops sending (``next_load`` returns ``+inf``)
once a send could no longer help the decode that has already succeeded,
and finalizes at the decode-success time.  Without churn ``adaptive_rate``
is ``ccp`` bit for bit (``p_hat`` stays 0).

Port of ``repro.core.policies.adaptive_rate`` on a leading rep dimension:
state (B, N), the decoder feedback (B,) broadcast over helpers.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import ccp as ccp_mod
from .. import decode as decode_mod
from .base import StepCtx, register
from .ccp import CCPPolicy


def _ewma_up(w: float, p_hat: torch.Tensor) -> torch.Tensor:
    """``w + (1 - w) * p_hat`` rounded once, as one fused multiply-add:
    the reference's XLA CPU build contracts this expression into an FMA,
    and two roundings move ``p_hat`` by an ulp on many float32 inputs."""
    return torch.addcmul(torch.full_like(p_hat, w), p_hat, torch.full_like(p_hat, 1.0 - w))


@dataclasses.dataclass(frozen=True)
class AdaptiveRatePolicy(CCPPolicy):
    """CCP + measured-loss code-rate adaptation (see module docstring)."""

    version = 1

    loss_ewma: float = 0.1   # EWMA weight of the per-helper loss estimate
    p_clip: float = 0.5      # cap on the rate compensation (overhead <= 2x)
    outage_run: int = 4      # consecutive losses before backoff engages
    #: close the loop with the fountain decoder: stop sending on decode
    #: success and finalize at the decode-success time
    decoder_feedback: bool = False

    @property
    def name(self) -> str:
        return "adaptive_rate_fb" if self.decoder_feedback else "adaptive_rate"

    @property
    def uses_decoder(self) -> bool:
        return self.decoder_feedback

    def init(self, shape, device):
        state = super().init(shape, device)
        return dict(state, p_hat=torch.zeros(shape, device=device),
                    consec=torch.zeros(shape, dtype=torch.int32, device=device))

    def on_computed(self, state, ctx: StepCtx):
        new = super().on_computed(state, ctx)
        w = self.loss_ewma
        # p_hat and consec from the state before the hooks (the CCP rings
        # are updated in place, these two are not).
        return dict(
            new,
            p_hat=torch.where(ctx.received, (1.0 - w) * state["p_hat"], state["p_hat"]),
            consec=torch.where(ctx.received, 0, state["consec"]),
        )

    def _tti_scale(self, state, ctx: StepCtx):
        # Send 1/(1-p_hat) coded packets per useful one.
        return 1.0 - torch.minimum(state["p_hat"], ccp_mod._scalar(self.p_clip, state["p_hat"]))

    def _stop_after_decode(self, tx, ctx: StepCtx):
        """``+inf`` (stop) for sends at or past the decode-success bound
        once the decode has succeeded: the gate is the *time* bound, not
        the step-aligned done flag (StepCtx doc)."""
        done = ctx.decode_done[:, None] & (tx >= ctx.decode_t_done[:, None])
        return torch.where(done, torch.inf, tx)

    def on_timeout(self, state, ctx: StepCtx, tx_next):
        deadline = self._deadline(state, ctx)
        w = self.loss_ewma
        p_hat = torch.where(ctx.lost, _ewma_up(w, state["p_hat"]), state["p_hat"])
        consec = torch.where(ctx.lost, state["consec"] + 1, state["consec"])
        # Back off only when the loss run looks like an outage, not an
        # erasure burst the adapted code rate already absorbs.
        est = ccp_mod.on_timeout(state["est"], ctx.lost & (consec >= self.outage_run),
                                 max_backoff=ctx.max_backoff)
        tx_retx = ctx.tx + deadline
        if self.decoder_feedback:
            # No retransmission of a symbol the finished decode no longer needs.
            tx_retx = self._stop_after_decode(tx_retx, ctx)
        return dict(state, est=est, p_hat=p_hat, consec=consec), tx_retx

    def prepare(self, cfg, R: int, ccp_cfg, mu, a, rate) -> dict:
        aux = super().prepare(cfg, R, ccp_cfg, mu, a, rate)
        if not self.decoder_feedback:
            return aux
        return dict(aux, decoder=decode_mod.decoder_aux(R, mu.shape[0], mu.device))

    def next_load(self, state, ctx: StepCtx) -> torch.Tensor:
        tx = super().next_load(state, ctx)
        if self.decoder_feedback:
            tx = self._stop_after_decode(tx, ctx)
        return tx

    def finalize(self, outs, aux, cfg, R: int, kk: int, tx_end):
        if not self.decoder_feedback:
            return super().finalize(outs, aux, cfg, R, kk, tx_end)
        return decode_mod.finalize_decode(outs, aux, R, tx_end)

    def summary(self, state) -> dict:
        return {"p_hat": state["p_hat"]}


register("adaptive_rate", factory=AdaptiveRatePolicy)
# Decode-aware variant: a tighter outage window (2 instead of 4 consecutive
# losses), because a send wasted into an outage burns a distinct coded
# symbol, not just pacing budget.
register("adaptive_rate_fb",
         factory=lambda: AdaptiveRatePolicy(decoder_feedback=True, outage_run=2))
