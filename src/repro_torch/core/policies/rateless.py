"""Rateless CCP: completion by *actual* LT decode success, not packet count.

Counter-based CCP declares the task done at the (R+K)-th received packet, an
idealized MDS abstraction that hides the LT code's overhead randomness.
``rateless_ccp`` keeps Algorithm 1's pacing bit for bit but runs the
incremental peeling decoder of :mod:`repro_torch.core.decode` in the loop:

* every send carries a fresh coded symbol (send-time ids: systematic for
  ids < R, then a parity pool);
* the engine absorbs each arrival into the loop-carried decoder state and
  feeds ``decoded_count / ripple / decode_done`` back through
  :class:`~repro_torch.core.policies.base.StepCtx`;
* ``finalize`` binary-searches the time-sorted arrival prefix for the first
  decodable set (:func:`repro_torch.core.decode.decode_completion`).

The measured per-rep LT overhead is ``r_n.sum(-1) - R``.

Port of ``repro.core.policies.rateless``.
"""

from __future__ import annotations

import dataclasses

from .. import decode as decode_mod
from .base import register
from .ccp import CCPPolicy


@register
@dataclasses.dataclass(frozen=True)
class RatelessCCPPolicy(CCPPolicy):
    """Algorithm-1 pacing + decoder-in-the-loop completion (module doc)."""

    name = "rateless_ccp"
    version = 1
    uses_decoder = True

    def prepare(self, cfg, R: int, ccp_cfg, mu, a, rate) -> dict:
        aux = super().prepare(cfg, R, ccp_cfg, mu, a, rate)
        # One pool code for every rep (host-side, memoized), sent to the
        # run's device once.
        return dict(aux, decoder=decode_mod.decoder_aux(R, mu.shape[0], mu.device))

    def finalize(self, outs, aux, cfg, R: int, kk: int, tx_end):
        return decode_mod.finalize_decode(outs, aux, R, tx_end)
