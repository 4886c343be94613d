"""Per-helper feedback-RTT processes (the ``ChurnConfig.rtt_*`` knobs).

The feedback RTT of helper n at packet i factors as ``rtt_base[n] *
rtt_jit[n, i]``: a static per-helper base (``rtt_het`` spreads helpers
uniformly in ``rtt_mean * [1 - het, 1 + het]``) times a unit-mean
per-packet jitter drawn by regime:

  'fixed'      no jitter (a provisioned control path);
  'lognormal'  log-normal, mean 1, log-std ``rtt_sigma`` (queueing jitter);
  'cell'       with prob ``rtt_spike_prob`` the sample is
               ``rtt_spike_scale`` times the base, else 1 (cellular
               latency spikes).

The factorization lets a fleet share the per-helper base across tenants (a
helper's control path is a helper property, like ``mu``) while each tenant
draws its own per-packet jitter.  :func:`repro_torch.core.simulator.
draw_dynamics` draws these tables after every churn table, so turning the
transport layer on never changes a churn draw.
"""

from __future__ import annotations

import torch

__all__ = ["RTT_DISTS", "draw_rtt_tables"]

#: 'off' disables the transport path (the structural knob the engine loop
#: specializes on through ``ChurnConfig.static_key()``).
RTT_DISTS = ("off", "fixed", "lognormal", "cell")


def draw_rtt_tables(gen: torch.Generator, ch, B: int, N: int, M: int) -> dict:
    """Transport tables for ``B`` reps, float32 on the generator's device:
    ``rtt_base`` (B, N) per-helper base RTT, ``rtt_jit`` (B, N, M) unit-mean
    per-packet jitter and ``ack_u`` (B, N, M) uniforms of the ACK-loss draw
    (:func:`repro_torch.core.transport.delay.observation_delay`).  ``ch`` is
    the :class:`~repro_torch.core.simulator.ChurnConfig` with the ``rtt_*``
    knobs."""
    dev = gen.device
    u = torch.rand((B, N), generator=gen, device=dev)
    base = ch.rtt_mean * (1.0 + ch.rtt_het * (2.0 * u - 1.0))
    if ch.rtt_dist == "lognormal":
        # exp(sigma z - sigma^2/2): unit mean, log-std rtt_sigma.
        mu_log = -0.5 * ch.rtt_sigma ** 2
        z = torch.randn((B, N, M), generator=gen, device=dev)
        jit = torch.exp(mu_log + ch.rtt_sigma * z)
    elif ch.rtt_dist == "cell":
        spike = torch.rand((B, N, M), generator=gen, device=dev) < ch.rtt_spike_prob
        jit = torch.where(spike, ch.rtt_spike_scale, 1.0)
    else:  # 'fixed'
        jit = torch.ones((B, N, M), device=dev)
    ack_u = torch.rand((B, N, M), generator=gen, device=dev)
    return dict(rtt_base=base, rtt_jit=jit, ack_u=ack_u)
