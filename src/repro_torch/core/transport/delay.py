"""The feedback delay line: when does the controller *observe* an event?

A result that physically reaches the collector at ``tr`` is observed by
the pacing controller at ``tr + observation_delay``: one feedback RTT,
doubled when the ACK itself is lost (the controller times out and the
collector answers the NACK-style retransmission request one RTT later; the
retransmitted ACK is assumed delivered).

ACK loss composes with the data plane's loss processes: the ACK of packet
i fades with the Gilbert–Elliott chain state that governs data loss at
step i, plus the i.i.d. ``drop_prob`` floor:

    p_ack = p_drop + l_state - p_drop * l_state      (union of the two)

Everything broadcasts, so a fleet's (B, T, N) jitter and ACK draws meet
the shared (B, N) chain state and base RTT.  Port of
``repro.core.transport.delay``.
"""

from __future__ import annotations

import torch

__all__ = ["observation_delay"]


def observation_delay(rtt_fb, ack_u, p_drop, ge_bad=None, ge_params=None):
    """Observation lag of this step's feedback, elementwise over helpers.

    rtt_fb:    feedback RTT samples, any shape.
    ack_u:     ACK-loss uniforms, the same shape.
    p_drop:    the i.i.d. loss floor (``ChurnConfig.drop_prob``): a float or
               a float32 tensor broadcastable against ``rtt_fb``.
    ge_bad:    bool Gilbert–Elliott state at this step, or None.
    ge_params: the chain's (p_bad, p_good, loss_good, loss_bad), each
               broadcastable against ``ge_bad`` (``engine._ge_params``), or
               None.

    Returns the delay to add to every observed instant: ``rtt_fb`` on a
    clean ACK, ``2 * rtt_fb`` when the ACK was lost and retransmitted.
    With ``rtt_fb == 0`` the result is exactly ``0.0``: the RTT=0
    guarantee rests on ``x + 0.0 == x`` for the engine's non-negative
    times.
    """
    p_ack = p_drop
    if ge_bad is not None:
        l_state = torch.where(ge_bad, ge_params[3], ge_params[2])
        # One fused multiply-add, as the reference's XLA CPU build computes it.
        p = torch.as_tensor(p_drop, dtype=l_state.dtype, device=l_state.device)
        p_ack = torch.addcmul(p + l_state, -p, l_state)
    ack_lost = ack_u < p_ack
    return rtt_fb * (1.0 + ack_lost)
