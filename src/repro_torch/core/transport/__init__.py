"""Transport layer: delayed ACK/NACK feedback, RTT processes, TFRC pacing.

The engine's loop idealizes the control plane: every ``StepCtx``
observation (``on_computed`` receipts, ``decoded_count``, ``queue_delay``)
reaches the pacing controller the instant the underlying event happens.
This package models the feedback channel between the collector and the
controller as a real link: per-helper RTT processes (:mod:`.rtt`: fixed,
log-normal-jittered and cellular-spike regimes), ACK loss composed with the
Gilbert–Elliott burst chain with one NACK-style retransmission round
(:mod:`.delay`), and the TFRC (RFC 5348) throughput-equation pacing of the
``tfrc_ccp`` policy (:mod:`.tfrc`).

The contract: the delay line shifts *observations only*.  Ground-truth
physics (result arrival times ``outs["tr"]``, helper idle, completion
extraction, decode success) stays time-exact; what moves is when the
policy hooks *learn* about it (``ctx.tr_ok``/``ctx.rtt_ack``/``ctx.tr_prev``
become observed instants, and ``decode_t_done`` a collector-observed
bound).  With ``rtt_mean = 0`` the observed and physical instants coincide
bit for bit, so the transport-enabled loop is bitwise the idealized engine.

Port of ``repro.core.transport``: tensors with a leading rep axis, draws
from an explicit ``torch.Generator``.
"""

from .delay import observation_delay
from .rtt import RTT_DISTS, draw_rtt_tables
from .tfrc import loss_event_update, tfrc_send_interval

__all__ = [
    "RTT_DISTS",
    "draw_rtt_tables",
    "loss_event_update",
    "observation_delay",
    "tfrc_send_interval",
]
