"""Offloading policies: protocol, step context, and registry.

A :class:`Policy` packages everything that distinguishes one offloading
strategy from another — when to send the next packet, how to react to a
computed-packet receipt or a loss, and how to declare the task complete —
while the *scenario dynamics* (helper draws, link/compute timing, churn)
stay in :mod:`repro_torch.core.engine`.  The engine's per-packet loop calls the
hooks with a :class:`StepCtx` whose tensors carry a leading rep dimension,
``(B, N)``, in place of the reference's ``vmap``.

Protocol (port of ``repro.core.policies.base``):

``prepare(cfg, R, ccp_cfg, mu, a, rate) -> aux``
    Per-rep auxiliary dict computed once before the stream from the helper
    draw ((B, N) tensors).
``init(shape, device) -> state``
    Per-helper policy state for helpers of ``shape`` = (B, N).
``on_computed(state, ctx) -> state``
    Process the receipt of packet ``ctx.i``'s computed result.
``next_load(state, ctx) -> tx_next``
    The pacing decision: the send time of packet ``i+1`` per helper.
``on_timeout(state, ctx, tx_next) -> (state, tx_retx)``
    Only invoked under churn.  React to lost packets (``ctx.lost``) and
    return the retransmission send time; the engine applies it as
    ``where(lost, tx_retx, tx_next)``.  Default: no reaction.
``finalize(outs, aux, cfg, R, kk, tx_end) -> (T, valid)``
    Completion rule.  Default: the fountain-coded (R+K)-th order statistic
    (:func:`repro_torch.core.simulator.completion_time`).  ``tx_end`` is
    the send time of the first unsimulated packet under churn, and None on
    the static path, as in the reference.  Block-assignment policies
    override (every/enough helpers must finish their block).
``packet_mask(aux, n, m) -> (B, N, M) bool | None``
    Which simulated packets physically exist (block policies send only
    ``loads[n]``); ``None`` means all.  Masked packets are excluded from
    the per-helper efficiency/contribution statistics.
``report_aux``
    Class attribute: the ``aux`` keys the engine copies into the results
    as ``x_<key>`` (``RunResult.extras``), e.g. the block policies'
    ``("loads",)``.
``backoff(state) -> tensor | None``
    Current timeout-backoff factor for the trace (None -> ones).
``summary(state) -> dict``
    Per-helper values from the final policy state, surfaced in
    :class:`repro_torch.core.engine.RunResult` extras.
``horizon_hint(cfg, R, kk) -> int | None``
    Optional scan-horizon hint (see ``engine._initial_m``).

Fleet runs (``Engine.run_fleet``) drive the same hooks once per tenant per
round, on ``(B*T, N)`` rows (rep-major: row ``b*T + t`` is rep b's tenant
t), with ``StepCtx.queue_delay`` and ``StepCtx.contention`` filled (None on
the single-task path).  Fixed-allocation block policies declare
``fleet_aux = "per_task"`` so :meth:`Policy.prepare_fleet` allocates their
loads over each tenant's recruited helpers.

Decoder feedback (``uses_decoder = True``): the engine additionally runs the
incremental peeling decoder of :mod:`repro_torch.core.decode` inside the
loop and fills ``StepCtx.decoded_count`` / ``ripple`` / ``decode_done`` /
``decode_t_done``.  Such a policy's ``prepare`` returns
``decode.decoder_aux(R, batch, device)`` under ``aux["decoder"]`` (see
``policies/rateless.py``); its ``finalize`` typically replaces the packet
count with :func:`repro_torch.core.decode.decode_completion`.

Policies are frozen dataclasses; per-rep data flows through ``aux`` and
``state``, never through instance attributes.  ``register(cls)`` adds a
policy class under its ``name``; ``get(name)`` instantiates; ``names()``
lists.  Unknown names raise with the known list.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["RING", "StepCtx", "Policy", "register", "get", "names"]

RING = 16  # ring-buffer slots for in-flight (Tr, TTI) pairs

# Reference policies still to be ported, with the ROADMAP item that brings
# each (queue 1 of ROADMAP.md): none since the transport slice.
NOT_PORTED: Dict[str, str] = {}


@dataclasses.dataclass
class StepCtx:
    """Per-packet step context handed to the policy hooks.

    Tensor fields are (B, N) slices for packet ``i`` ((B*T, N) in a fleet).
    With the transport layer on (``ChurnConfig.rtt_dist != 'off'``),
    ``tr_ok``, ``rtt_ack``, ``tr_prev`` and ``decode_t_done`` are *observed*
    instants: the physical event shifted by the sampled feedback delay (one
    RTT, two when the ACK was lost).  The engine's trace stays physical.
    """

    i: int                  # packet index
    n: int                  # helper count
    tx: torch.Tensor        # send time of packet i
    arrive: torch.Tensor    # uplink arrival time
    start: torch.Tensor     # compute start (FIFO queue)
    beta: torch.Tensor      # effective runtime (churn-scaled)
    tr_ok: torch.Tensor     # (observed) result-arrival time if not lost
    lost: torch.Tensor      # bool: packet lost (churn; always False when static)
    received: torch.Tensor  # bool: sent and not lost
    rtt_ack: torch.Tensor   # (observed) receipt-ACK RTT sample
    d_up: torch.Tensor      # uplink delay of packet i
    d_down: torch.Tensor    # result downlink delay
    d_ack: torch.Tensor     # ACK downlink delay
    tr_prev: torch.Tensor   # Tr of the previous *received* packet
    cfg: object             # repro_torch.core.ccp.CCPConfig
    aux: dict               # policy.prepare() output
    max_backoff: Optional[float] = None  # churn backoff cap (None when static)
    # Decoder feedback (filled only when policy.uses_decoder; else None),
    # each (B,): it reflects every result absorbed through step i.
    decoded_count: Optional[torch.Tensor] = None  # i32 recovered sources
    ripple: Optional[torch.Tensor] = None         # i32 released this step
    decode_done: Optional[torch.Tensor] = None    # bool all R recovered
    # Real-time upper bound on the decode completion instant: the max
    # arrival time over the absorbed set when decode_done first fired (+inf
    # until then).  The loop is step-aligned, not time-aligned, so only
    # sends at tx >= decode_t_done are provably useless; stop rules gate on
    # this, not on decode_done alone.
    decode_t_done: Optional[torch.Tensor] = None  # f32
    # Fleet contention (filled only by the fleet loop, None on the single-task
    # path): how long this packet waited behind other tenants at its helper
    # (compute start minus the start a dedicated helper would have given),
    # and how many tenants each helper served this round.
    queue_delay: Optional[torch.Tensor] = None  # f32
    contention: Optional[torch.Tensor] = None   # i32


class Policy:
    """Base policy: every hook has the neutral default (see module doc)."""

    name: str = "base"
    version: int = 1
    #: horizon-cap multiple of R+K (None -> engine default: 1 static / 4 churn)
    m_cap_factor: Optional[int] = None
    #: True -> the engine runs the incremental peeling decoder in the loop
    #: and fills StepCtx.decoded_count/ripple/decode_done/decode_t_done.
    uses_decoder: bool = False
    #: aux keys copied into the results as ``x_<key>`` (see module doc)
    report_aux: tuple = ()
    #: fleet aux layout: "shared" (one ``prepare`` aux for every tenant) or
    #: "per_task" (``prepare_fleet``: one aux per tenant over its recruit
    #: set).  "per_task" is incompatible with ``uses_decoder``.
    fleet_aux: str = "shared"

    def prepare(self, cfg, R: int, ccp_cfg, mu, a, rate) -> dict:
        return {}

    def prepare_fleet(self, cfg, R: int, ccp_cfg, mu, a, rate, recruit) -> dict:
        """Per-tenant aux for ``Engine.run_fleet`` (called only when
        ``fleet_aux == "per_task"``): one :meth:`prepare` aux per tenant,
        with the helpers it did not recruit given mu = 0, so every
        weight-proportional block allocation lands on its recruit set.
        mu/a/rate (B, N), recruit (B, T, N); every aux tensor comes back
        (B, T, ...)."""
        B, T, N = recruit.shape
        rows = lambda v: v.repeat_interleave(T, dim=0)  # noqa: E731
        mu_t = torch.where(recruit.reshape(B * T, N), rows(mu), 0.0)
        aux = self.prepare(cfg, R, ccp_cfg, mu_t, rows(a), rows(rate))
        return {k: v.reshape(B, T, *v.shape[1:]) for k, v in aux.items()}

    def init(self, shape, device):
        return {}

    def on_computed(self, state, ctx: StepCtx):
        return state

    def next_load(self, state, ctx: StepCtx) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__}.next_load")

    def on_timeout(self, state, ctx: StepCtx, tx_next) -> Tuple[object, torch.Tensor]:
        return state, tx_next

    def finalize(self, outs, aux, cfg, R: int, kk: int, tx_end):
        from ..simulator import completion_time  # lazy: avoids import cycle
        return completion_time(outs["tr"], kk, tx_end=tx_end)

    def packet_mask(self, aux, n: int, m: int):
        return None

    def backoff(self, state):
        return None

    def summary(self, state) -> dict:
        return {}

    def horizon_hint(self, cfg, R: int, kk: int) -> Optional[int]:
        return None

    def __repr__(self) -> str:  # registry name is the canonical identity
        return f"<policy {self.name!r} v{self.version}>"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], Policy]] = {}


def register(name_or_cls, *, factory: Optional[Callable[[], Policy]] = None):
    """Register a policy class (``@register``) or a named factory
    (``register("naive_oracle", factory=lambda: NaivePolicy(oracle=True))``)."""
    if isinstance(name_or_cls, str):
        if factory is None:
            raise ValueError("register(name, ...) requires factory=")
        _REGISTRY[name_or_cls] = factory
        return factory
    _REGISTRY[name_or_cls.name] = name_or_cls
    return name_or_cls


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
