"""Offloading policies: protocol, step context, and registry.

A :class:`Policy` packages everything that distinguishes one offloading
strategy from another — when to send the next packet, how to react to a
computed-packet receipt, and how to declare the task complete — while the
*scenario dynamics* (helper draws, link/compute timing) stay in
:mod:`repro_torch.core.engine`.  The engine's per-packet loop calls the
hooks with a :class:`StepCtx` whose tensors carry a leading rep dimension,
``(B, N)``, in place of the reference's ``vmap``.

Protocol (port of ``repro.core.policies.base``, static path):

``prepare(cfg, R, ccp_cfg, mu, a, rate) -> aux``
    Per-rep auxiliary dict computed once before the stream from the helper
    draw ((B, N) tensors).
``init(shape, device) -> state``
    Per-helper policy state for helpers of ``shape`` = (B, N).
``on_computed(state, ctx) -> state``
    Process the receipt of packet ``ctx.i``'s computed result.
``next_load(state, ctx) -> tx_next``
    The pacing decision: the send time of packet ``i+1`` per helper.
``finalize(outs, aux, cfg, R, kk) -> (T, valid)``
    Completion rule.  Default: the fountain-coded (R+K)-th order statistic
    (:func:`repro_torch.core.simulator.completion_time`).
``backoff(state) -> tensor | None``
    Current timeout-backoff factor for the trace (None -> ones).
``horizon_hint(cfg, R, kk) -> int | None``
    Optional scan-horizon hint (see ``engine._initial_m``).

Policies are frozen dataclasses; per-rep data flows through ``aux`` and
``state``, never through instance attributes.  ``register(cls)`` adds a
policy class under its ``name``; ``get(name)`` instantiates; ``names()``
lists.  Unknown names raise with the known list; names the reference
registers but the port has not ported yet raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["RING", "StepCtx", "Policy", "register", "get", "names"]

RING = 16  # ring-buffer slots for in-flight (Tr, TTI) pairs

# Reference policies still to be ported, with the ROADMAP item that brings
# each (queue 1 of ROADMAP.md).
NOT_PORTED = {
    "naive": "rateless/decoder slice (naive, naive_oracle)",
    "naive_oracle": "rateless/decoder slice (naive, naive_oracle)",
    "rateless_ccp": "rateless/decoder slice (core/decode/peeling.py)",
    "adaptive_rate_fb": "rateless/decoder slice (core/decode/peeling.py)",
    "uncoded_mean": "baselines slice (block policies)",
    "uncoded_mu": "baselines slice (block policies)",
    "hcmm": "baselines slice (block policies)",
    "adaptive_rate": "baselines slice (block and adaptive policies)",
    "tfrc_ccp": "transport slice (core/transport/)",
}


@dataclasses.dataclass
class StepCtx:
    """Per-packet step context handed to the policy hooks.

    Tensor fields are (B, N) slices for packet ``i``.
    """

    i: int                  # packet index
    n: int                  # helper count
    tx: torch.Tensor        # send time of packet i
    arrive: torch.Tensor    # uplink arrival time
    start: torch.Tensor     # compute start (FIFO queue)
    beta: torch.Tensor      # runtime
    tr_ok: torch.Tensor     # result-arrival time if not lost
    lost: torch.Tensor      # bool: packet lost (always False on the static path)
    received: torch.Tensor  # bool: sent and not lost
    rtt_ack: torch.Tensor   # receipt-ACK RTT sample
    d_up: torch.Tensor      # uplink delay of packet i
    d_down: torch.Tensor    # result downlink delay
    d_ack: torch.Tensor     # ACK downlink delay
    tr_prev: torch.Tensor   # Tr of the previous *received* packet
    cfg: object             # repro_torch.core.ccp.CCPConfig
    aux: dict               # policy.prepare() output


class Policy:
    """Base policy: every hook has the neutral default (see module doc)."""

    name: str = "base"
    version: int = 1
    #: horizon-cap multiple of R+K (None -> engine default: 1 on the static path)
    m_cap_factor: Optional[int] = None

    def prepare(self, cfg, R: int, ccp_cfg, mu, a, rate) -> dict:
        return {}

    def init(self, shape, device):
        return {}

    def on_computed(self, state, ctx: StepCtx):
        return state

    def next_load(self, state, ctx: StepCtx) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__}.next_load")

    def finalize(self, outs, aux, cfg, R: int, kk: int):
        from ..simulator import completion_time  # lazy: avoids import cycle
        return completion_time(outs["tr"], kk)

    def backoff(self, state):
        return None

    def horizon_hint(self, cfg, R: int, kk: int) -> Optional[int]:
        return None

    def __repr__(self) -> str:  # registry name is the canonical identity
        return f"<policy {self.name!r} v{self.version}>"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], Policy]] = {}


def register(cls):
    """Class decorator: register a policy class under its ``name``."""
    _REGISTRY[cls.name] = cls
    return cls


def get(name: str) -> Policy:
    """Instantiate the registered policy ``name``; unknown names raise with
    the full known list."""
    if name in _REGISTRY:
        return _REGISTRY[name]()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"policy {name!r} is not ported yet (ROADMAP queue 1: "
            f"{NOT_PORTED[name]}); ported policies: {sorted(_REGISTRY)}")
    raise ValueError(
        f"unknown policy {name!r}; known policies: {sorted(_REGISTRY)}")


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
