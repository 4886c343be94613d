"""Computation Control Protocol (CCP) — Algorithm 1 of the paper.

The collector cannot observe per-packet compute times ``beta_{n,i}``; it only
sees packet send times and ACK arrival times.  CCP estimates ``E[beta]`` per
helper from that information and drives the transmission interval ``TTI`` to
it (eq. 8), with TCP-style multiplicative backoff on timeout.

Port of ``repro.core.ccp``: pure state-update functions over per-helper
tensors of any leading shape (the engine passes ``(reps, N)``).  The
arithmetic is the reference's operation for operation in float32, including
its ``inf``/``nan`` propagation (``torch.where``/``torch.maximum``, never
``clamp``), so the port's traces match the reference's.

Paper equation map:
  eq. (2)  XTT_{n,i+1} = Tr_{n,i} - Tx_{n,i+1}          (residual time)
  eq. (3)  RTT^data    = (Bx+Br)/(Bx+Back) * RTT^ack    (size rescale)
  eq. (4)  RTT^data    <- alpha*sample + (1-alpha)*ewma (EWMA)
  eq. (5)  E[beta]     = (Tc - Tu) / m                  (busy time / packets)
  eq. (6)  Tc          = Tr - Br/(Bx+Br) * RTT^data     (finish-time estimate)
  eq. (7)  Tu          <- Tu + max(0, RTT^data - XTT)   (under-utilization)
  eq. (8)  TTI         = min(Tr - Tx, E[beta])
  l.13-14  timeout: TTI <- 2*TTI ; TO = 2*(TTI + RTT^data)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["CCPConfig", "CCPState", "init_state", "on_computed", "on_timeout",
           "tti", "timeout_deadline", "arq_timeout"]


@dataclasses.dataclass(frozen=True)
class CCPConfig:
    """Packet-size and smoothing constants (paper §6 defaults).

    Bx is the transmitted-packet size in bits (8R in the paper: one byte per
    matrix entry per row), Br the computed-result size, Back the ACK size.
    ``alpha`` is the EWMA weight of eq. (4); the paper does not pin it — we
    default to 0.25 (between TCP's 1/8 and a fast-adapting 1/2) and expose it.
    """

    Bx: float
    Br: float = 8.0
    Back: float = 1.0
    alpha: float = 0.25

    @property
    def data_scale(self) -> float:
        """eq. (3): RTT^data / RTT^ack."""
        return (self.Bx + self.Br) / (self.Bx + self.Back)

    @property
    def back_frac(self) -> float:
        """eq. (6): backward-trip fraction of RTT^data."""
        return self.Br / (self.Bx + self.Br)

    @property
    def fwd_frac(self) -> float:
        """Alg. 1 line 7: forward-trip fraction of RTT^ack."""
        return self.Bx / (self.Bx + self.Back)


@dataclasses.dataclass
class CCPState:
    """Per-helper estimator state; every field is a tensor of one shape."""

    rtt_data: torch.Tensor  # EWMA of eq. (4)
    Tu: torch.Tensor        # cumulative under-utilization estimate, eq. (7)
    m: torch.Tensor         # packets processed (int32)
    e_beta: torch.Tensor    # eq. (5)
    tti_backoff: torch.Tensor  # multiplicative factor from timeouts (l.13)

    def replace(self, **kw) -> "CCPState":
        return dataclasses.replace(self, **kw)


def init_state(shape, device=None, dtype=torch.float32) -> CCPState:
    """Zero state for helpers of ``shape`` (an int N or a tuple such as
    ``(reps, N)``)."""
    return CCPState(
        rtt_data=torch.zeros(shape, dtype=dtype, device=device),
        Tu=torch.zeros(shape, dtype=dtype, device=device),
        m=torch.zeros(shape, dtype=torch.int32, device=device),
        e_beta=torch.zeros(shape, dtype=dtype, device=device),
        tti_backoff=torch.ones(shape, dtype=dtype, device=device),
    )


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d CPU tensor of ``like``'s type: the operand torch.maximum and
    torch.minimum need where the reference passes a Python float.  A 0-d
    CPU tensor is taken as a scalar by CUDA ops, so no copy is made."""
    return torch.tensor(v, dtype=like.dtype)


def _alpha_scale(cfg: CCPConfig) -> float:
    """``alpha * data_scale`` as the reference's compiler folds it: the
    product of the two float32 constants, rounded to float32."""
    return float(np.float32(np.float32(cfg.data_scale) * np.float32(cfg.alpha)))


def on_computed(
    state: CCPState,
    cfg: CCPConfig,
    tx_i: torch.Tensor,
    tr_i: torch.Tensor,
    tr_prev: torch.Tensor,
    rtt_ack: torch.Tensor,
    active: torch.Tensor,
) -> Tuple[CCPState, torch.Tensor]:
    """Process the computed-packet receipt for one packet per helper.

    All args share one shape; ``active`` masks helpers whose update applies.
    ``tr_prev`` is Tr_{n,i-1} (ignored for the first packet). Returns the new
    state and TTI_{n,i} per eq. (8).
    """
    first = state.m == 0
    rtt_sample = cfg.data_scale * rtt_ack
    # eq. (4), rounded as the reference's XLA CPU build computes it: the
    # constant alpha * data_scale is folded in float32, and the sum of the
    # two products is a fused multiply-add.  Which product it fuses differs
    # between the kernel that updates the estimator state and the one that
    # computes eq. (5)-(7): the state takes fma(rtt_ack, c, (1-alpha) ewma),
    # the estimates below fma(ewma, 1-alpha, c rtt_ack).  (One ulp of the
    # EWMA shows once the feedback delay makes it comparable to the TTI.)
    c = _alpha_scale(cfg)
    keep = torch.full_like(state.rtt_data, 1.0 - cfg.alpha)
    rtt_new = torch.where(first, rtt_sample, torch.addcmul(c * rtt_ack, keep, state.rtt_data))
    rtt_state = torch.where(first, rtt_sample, torch.addcmul(
        (1.0 - cfg.alpha) * state.rtt_data, torch.full_like(rtt_ack, c), rtt_ack))
    # eq. (2)/(7): XTT_i = Tr_{i-1} - Tx_i ; Tu += max(0, RTT - XTT)
    xtt = tr_prev - tx_i
    tu_inc = torch.maximum(_scalar(0.0, xtt), rtt_new - xtt)
    tu_new = torch.where(first, cfg.fwd_frac * rtt_ack, state.Tu + tu_inc)
    m_new = state.m + 1
    # eq. (6): helper-side finish-time estimate, one fused multiply-add.
    tc = torch.addcmul(tr_i, torch.full_like(rtt_new, -cfg.back_frac), rtt_new)
    # eq. (5).
    e_beta = torch.maximum((tc - tu_new) / m_new.to(tc.dtype), _scalar(1e-9, tc))
    # Successful receipt resets the timeout backoff (ACK arrived in time).
    new_state = CCPState(
        rtt_data=torch.where(active, rtt_state, state.rtt_data),
        Tu=torch.where(active, tu_new, state.Tu),
        m=torch.where(active, m_new, state.m),
        e_beta=torch.where(active, e_beta, state.e_beta),
        tti_backoff=torch.where(active, 1.0, state.tti_backoff),
    )
    tti_i = torch.minimum(tr_i - tx_i, e_beta) * new_state.tti_backoff
    return new_state, tti_i


def on_timeout(state: CCPState, active: torch.Tensor,
               max_backoff: float | None = None) -> CCPState:
    """Alg. 1 line 13: double the effective TTI of unresponsive helpers.

    ``max_backoff`` caps the multiplicative factor so a helper that drops out
    for a long stretch is still re-probed at a bounded interval and its
    rejoin is detected (the paper leaves the cap unspecified).
    """
    doubled = state.tti_backoff * 2.0
    if max_backoff is not None:
        doubled = torch.minimum(doubled, _scalar(max_backoff, doubled))
    return state.replace(
        tti_backoff=torch.where(active, doubled, state.tti_backoff)
    )


def tti(state: CCPState, tr_minus_tx: torch.Tensor) -> torch.Tensor:
    """eq. (8) with the current estimate and the last observed Tr - Tx."""
    return torch.minimum(tr_minus_tx, state.e_beta) * state.tti_backoff


def timeout_deadline(state: CCPState, tti_cur: torch.Tensor) -> torch.Tensor:
    """Alg. 1 line 14: TO = 2 * (TTI + RTT^data)."""
    return 2.0 * (tti_cur + state.rtt_data)


def arq_timeout(beta_mean, rtt_data):
    """Alg.-1-line-14-shaped retransmission timeout for estimator-free
    stop-and-wait baselines: TO = 2 * (E[beta] + RTT^data), with E[beta]
    supplied externally (worst-case class for the paper's Naive, the true
    per-helper mean for the oracle-timer variant) instead of eq. (5)."""
    return 2.0 * (beta_mean + rtt_data)
