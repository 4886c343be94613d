"""CCP-driven runtime scheduler: the paper's estimator over host telemetry
(port of ``repro.core.scheduler``).

The "helpers" are workers (here: serving replicas) and the radio ACKs become
step-completion wall times; the estimator arithmetic (eqs. 3-8) is the
port's ``core.ccp``, shared with the simulator.  The scheduler:

  * keeps per-worker E[beta] (time per unit work) estimates via eq. (5),
  * reallocates work units between steps with the optimal allocation of
    eq. (23) (integerized by largest remainder),
  * applies timeout backoff (Alg. 1 l.13) and flags workers dead once the
    backoff crosses ``drop_after`` doublings.

Its inputs are host wall times and its outputs host integers, so its state
lives on the CPU in float32 (the reference's ``jnp`` default); nothing of it
goes to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import ccp as ccp_mod
from . import theory

__all__ = ["CCPScheduler"]

DEVICE = torch.device("cpu")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=DEVICE)


@dataclasses.dataclass
class CCPScheduler:
    n_workers: int
    alpha: float = 0.25
    timeout_factor: float = 2.0
    drop_after: int = 3          # backoff doublings before declaring dead
    cfg: ccp_mod.CCPConfig = None
    state: ccp_mod.CCPState = None
    _clock: Optional[np.ndarray] = None  # per-worker busy-time virtual clock
    _work: Optional[np.ndarray] = None   # last allocation (units per worker)

    def __post_init__(self):
        # Bx/Br/Back are vestigial here (telemetry has no packet sizes);
        # Bx >> Br keeps the eq. (3)/(6) corrections negligible.
        self.cfg = ccp_mod.CCPConfig(Bx=1e6, Br=8.0, Back=1.0, alpha=self.alpha)
        self.state = ccp_mod.init_state(self.n_workers, device=DEVICE)
        self._work = np.ones(self.n_workers)
        self._clock = np.zeros(self.n_workers)

    # -- telemetry ---------------------------------------------------------

    def observe_step(self, durations: Sequence[float],
                     rtts: Optional[Sequence[float]] = None) -> None:
        """Feed one step's per-worker wall times (seconds).  ``durations[i]``
        covers ``self._work[i]`` units of work; the estimator sees synthetic
        (Tx, Tr) pairs on a virtual clock, so eq. (5)'s busy-time
        normalization yields the per-unit cost estimate directly."""
        d = np.asarray(durations, dtype=np.float64)
        units = np.maximum(self._work, 1)
        per_unit = d / units
        rtt = np.asarray(rtts if rtts is not None else np.full_like(d, 1e-4))
        finite = np.isfinite(d)
        pu = np.where(finite, per_unit, 0.0)
        self.state, _ = ccp_mod.on_computed(
            self.state, self.cfg, _f32(self._clock), _f32(self._clock + pu + rtt),
            _f32(self._clock), _f32(rtt), torch.as_tensor(finite, device=DEVICE),
        )
        if not finite.all():
            self.state = ccp_mod.on_timeout(self.state, torch.as_tensor(~finite, device=DEVICE))
        self._clock = self._clock + pu

    # -- decisions ---------------------------------------------------------

    @property
    def e_beta(self) -> np.ndarray:
        e = self.state.e_beta.numpy().astype(np.float64)
        backoff = self.state.tti_backoff.numpy().astype(np.float64)
        e = np.where(e <= 0, np.nanmean(e[e > 0]) if (e > 0).any() else 1.0, e)
        return e * backoff  # backoff inflates the effective cost (Alg.1 l.13)

    def allocation(self, total_units: int) -> np.ndarray:
        """eq. (23): units_n proportional to 1/E[beta_n]; integers summing to
        total_units.  Dead workers get 0."""
        e = self.e_beta
        alive = ~self.dead_mask()
        inv = np.where(alive, 1.0 / e, 0.0)
        if inv.sum() == 0:
            inv = np.ones(self.n_workers)
        loads = total_units * inv / inv.sum()
        out = theory.largest_remainder_round(loads, total_units)
        self._work = np.maximum(out, 1)
        return out

    def dead_mask(self) -> np.ndarray:
        return self.state.tti_backoff.numpy() >= 2.0 ** self.drop_after

    def timeout_deadline(self) -> np.ndarray:
        """Per-worker step deadline (Alg. 1 l.14): 2*(TTI + RTT)."""
        e = self.e_beta * np.maximum(self._work, 1)
        rtt = self.state.rtt_data.numpy()
        return 2.0 * (e + rtt)
