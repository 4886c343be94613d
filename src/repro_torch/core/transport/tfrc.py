"""TFRC (RFC 5348) pacing primitives of the ``tfrc_ccp`` policy.

The TFRC throughput equation bounds the sending rate by what a conformant
TCP flow would achieve at loss-event rate ``p`` and RTT ``R``.  With the
RFC's simplifications ``b = 1`` and ``t_RTO = 4R`` the packet size cancels
from the *send interval*:

    interval(p, R) = R * (sqrt(2p/3) + 12 * sqrt(3p/8) * p * (1 + 32 p^2))

``0`` at ``p = 0`` (no throttle), growing like ``R*sqrt(p)`` for small
``p`` and like ``R*p^3`` once timeouts dominate.

The loss-*event* rate differs from a raw loss fraction: losses within one
RTT of the first loss of an event count as one congestion signal.
:func:`loss_event_update` keeps a loop-carried EWMA of the per-packet
new-event indicator, decayed on every delivered packet and bumped only
when a loss starts a new event.

Port of ``repro.core.transport.tfrc``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["loss_event_update", "tfrc_send_interval"]

_TWO_THIRDS = float(np.float32(2.0 / 3.0))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device: torch's
    float32 ``sqrt`` on the CPU (its AVX-512 path) is off by an ulp on
    about 0.6% of inputs, the reference's is not.  A float64 square root
    rounded to float32 is correctly rounded."""
    return torch.sqrt(x.double()).float()


def tfrc_send_interval(p: torch.Tensor, rtt: torch.Tensor) -> torch.Tensor:
    """Minimum allowed send interval at loss-event rate ``p`` and RTT
    estimate ``rtt`` (elementwise): the inverse of the RFC 5348 throughput
    equation with b=1 and t_RTO=4*RTT (module doc).

    Rounded as the reference's XLA CPU build computes it: ``2p/3`` and
    ``3p/8`` become ``p * f32(2/3)`` and ``p * 0.375``, and both sums of a
    product are fused multiply-adds (``torch.addcmul``)."""
    p = torch.clamp(p, 0.0, 1.0)
    timeout_term = _sqrt(p * 0.375) * 12.0 * p
    growth = torch.addcmul(torch.ones_like(p), 32.0 * p, p)
    return rtt * torch.addcmul(_sqrt(p * _TWO_THIRDS), timeout_term, growth)


def loss_event_update(p_ev, ev_start, lost, received, tx, rtt, *, w: float):
    """One step of the loss-event-rate estimator.

    p_ev:     current loss-event-rate EWMA.
    ev_start: send instant of the first loss of the current event (-inf
              before any loss).
    lost:     bool, this packet was lost.
    received: bool, this packet was delivered.
    tx:       this packet's send instant.
    rtt:      RTT estimate: losses within ``rtt`` of ``ev_start`` collapse
              into the ongoing event.
    w:        EWMA weight.

    Returns ``(p_ev, ev_start)``.  A delivered packet decays the rate, a
    loss that starts a new event bumps it, and a loss inside the ongoing
    event's window (or a never-sent slot) leaves it.
    """
    new_event = lost & (tx > ev_start + rtt)
    p_next = torch.where(new_event, w + (1.0 - w) * p_ev,
                         torch.where(received, (1.0 - w) * p_ev, p_ev))
    return p_next, torch.where(new_event, tx, ev_start)
