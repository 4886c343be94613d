"""Scenario model of the paper's §6 simulations: configs, random draws,
completion-time and efficiency extraction, and horizon heuristics.

A collector offloads fountain-coded packets to ``N`` heterogeneous helpers
over links with random per-packet rates; helper ``n`` computes packet ``i``
in ``beta_{n,i}`` (Scenario 1: i.i.d. shifted-exponential per packet;
Scenario 2: one draw per helper).  The completion time is when the collector
has received ``R+K`` computed packets.  The per-packet timeline itself is
simulated by :func:`repro_torch.core.engine.policy_stream`.

Port of the static part of ``repro.core.simulator``.  Every table carries a
leading rep dimension ``(B, N[, M])`` in place of the reference's ``vmap``,
and is float32 as the reference's are (JAX runs with x64 off).  Draws use an
explicit ``torch.Generator``: they follow the reference's distributions but
not its bits (tests compare moments, and inject JAX-drawn tables through
:mod:`repro_torch.interop` where bits matter).  The churn model
(``ChurnConfig``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import ccp as ccp_mod
from . import theory

__all__ = [
    "ScenarioConfig",
    "draw_helpers",
    "draw_packet_tables",
    "class_weights",
    "completion_time",
    "efficiency_measured",
]


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Paper §6 simulation setup.

    scenario: 1 (i.i.d. per-packet runtimes / Model I) or
              2 (one runtime draw per helper / Model II).
    a_mode:   'const' -> a_n = a_const;  'inv_mu' -> a_n = 1/mu_n.
    mu_choices: helper speeds drawn uniformly from this set.
    rate_lo/rate_hi: per-helper mean link rate bounds (bits/sec); per-packet
      rates are Poisson with that mean (in Mbps), floored at 0.5 Mbps.
    churn: must be None (the paper's static setup); the reference's
      ``ChurnConfig`` is not ported yet.
    """

    N: int = 100
    scenario: int = 1
    mu_choices: Tuple[float, ...] = (1.0, 2.0, 4.0)
    a_mode: str = "const"
    a_const: float = 0.5
    rate_lo: float = 10e6
    rate_hi: float = 20e6
    overhead: float = 0.05  # K = ceil(overhead * R)
    alpha: float = 0.25     # EWMA weight, eq. (4)
    churn: Optional[object] = None

    def __post_init__(self):
        if self.churn is not None:
            raise NotImplementedError(
                "churn is not ported yet (ROADMAP queue 1, 'baselines, churn, "
                "transport and fleet' slice); use churn=None")

    def K(self, R: int) -> int:
        return int(np.ceil(self.overhead * R))

    def ccp_cfg(self, R: int) -> ccp_mod.CCPConfig:
        # Paper: Bx = 8R bits, Br = 8 bits, Back = 1 bit.
        return ccp_mod.CCPConfig(Bx=8.0 * R, Br=8.0, Back=1.0, alpha=self.alpha)


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as the reference computes it: num rounded to t's type,
    then one division (``float / Tensor`` in torch multiplies by the
    reciprocal instead)."""
    return torch.full_like(t, num) / t


def draw_helpers(gen: torch.Generator, cfg: ScenarioConfig, reps: int):
    """Draw per-helper (mu_n, a_n, mean link rate), each (reps, N) float32
    on the generator's device."""
    dev = gen.device
    choices = torch.tensor(cfg.mu_choices, dtype=torch.float32, device=dev)
    pick = torch.randint(len(cfg.mu_choices), (reps, cfg.N), generator=gen,
                         device=dev)
    mu = choices[pick]
    if cfg.a_mode == "const":
        a = torch.full((reps, cfg.N), cfg.a_const, dtype=torch.float32, device=dev)
    elif cfg.a_mode == "inv_mu":
        a = _rdiv(1.0, mu)
    else:
        raise ValueError(f"unknown a_mode {cfg.a_mode!r}")
    u = torch.rand((reps, cfg.N), generator=gen, device=dev)
    rate = cfg.rate_lo + (cfg.rate_hi - cfg.rate_lo) * u
    return mu, a, rate


def draw_packet_tables(gen: torch.Generator, cfg: ScenarioConfig, mu, a, rate,
                       M: int, R: int):
    """Per-packet tables, each (B, N, M) float32: beta, d_up, d_ack, d_down."""
    B, N = mu.shape
    dev = mu.device
    if cfg.scenario == 1:
        eps = torch.empty((B, N, M), device=dev).exponential_(generator=gen)
        beta = a[..., None] + eps / mu[..., None]
    elif cfg.scenario == 2:
        eps = torch.empty((B, N), device=dev).exponential_(generator=gen)
        beta = (a + eps / mu)[..., None].expand(B, N, M)
    else:
        raise ValueError(f"scenario must be 1 or 2, got {cfg.scenario}")
    # Per-packet link rates: Poisson around the per-helper mean (in Mbps),
    # floored to avoid div-by-zero on a zero draw.
    lam = (rate / 1e6)[..., None].expand(B, N, M).contiguous()
    up = torch.poisson(lam, generator=gen).clamp_min(0.5) * 1e6
    dn = torch.poisson(lam, generator=gen).clamp_min(0.5) * 1e6
    c = cfg.ccp_cfg(R)
    return beta, _rdiv(c.Bx, up), _rdiv(c.Back, dn), _rdiv(c.Br, dn)


# ---------------------------------------------------------------------------
# Completion-time + efficiency extraction
# ---------------------------------------------------------------------------

def completion_time(tr: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per rep, the time when the k-th computed packet reaches the collector.

    tr: (B, N, M).  Returns (T, valid), each (B,): ``valid`` is False if the
    per-helper horizon M was too short to certify T (some helper might have
    contributed more packets by T than were simulated) — the caller re-runs
    with a larger M.  With fewer than k packets simulated (N*M < k) the
    index clamps to the last packet, as the reference's does, and the rep
    is never valid.
    """
    flat = torch.sort(tr.reshape(tr.shape[0], -1), dim=-1).values
    t = flat[:, min(k, flat.shape[1]) - 1]
    valid = (t <= tr[:, :, -1].amin(dim=-1)) & (k <= flat.shape[1])
    return t, valid


def efficiency_measured(tr, idle, beta, t_end) -> torch.Tensor:
    """Paper §6 'Efficiency': 1 - sum(idle)/sum(beta) over packets the helper
    computed within the completion horizon. tr/idle/beta (B, N, M), t_end
    (B,); returns (B, N) per-helper values (nan for a helper that computed
    nothing in time).

    The finiteness guard keeps packets with ``tr = inf`` (never received)
    from counting as computed when ``t_end`` is +inf."""
    t_end = t_end[:, None, None]
    within = torch.isfinite(tr) & (tr <= t_end)
    idle_sum = (idle * within).sum(dim=-1)
    busy_sum = (beta * within).sum(dim=-1)
    return torch.where(busy_sum > 0, 1.0 - idle_sum / (idle_sum + busy_sum),
                       torch.nan)


# ---------------------------------------------------------------------------
# Horizon heuristics (used by engine.Engine)
# ---------------------------------------------------------------------------

def _bucketed_horizon(cfg: ScenarioConfig, share: float, k: int) -> int:
    """~3x the fastest helper's fair share, bucketed to a power of two,
    capped at k = R+K: on the static path every helper streams
    back-to-back, so M = R+K always certifies."""
    m = int(np.ceil(3.0 * k * share)) + 64
    bucket = 1 << int(np.ceil(np.log2(max(m, 64))))
    return min(bucket, k)


def _horizon(cfg: ScenarioConfig, mu, a, R: int) -> int:
    """Per-draw horizon for the single-rep runner (mu, a: (N,) numpy)."""
    k = R + cfg.K(R)
    w = 1.0 / theory.shifted_exp_mean(np.asarray(a), np.asarray(mu))
    return _bucketed_horizon(cfg, float(w.max() / w.sum()), k)


def class_weights(cfg: ScenarioConfig):
    """Per-mu-class ``(mu, a, 1/E[beta])`` arrays from the choice set — the
    one place the ``a_mode`` mapping lives for horizon heuristics."""
    mu = np.asarray(cfg.mu_choices, dtype=np.float64)
    a = 1.0 / mu if cfg.a_mode == "inv_mu" else np.full_like(mu, cfg.a_const)
    return mu, a, 1.0 / theory.shifted_exp_mean(a, mu)


def _horizon_shared(cfg: ScenarioConfig, R: int) -> int:
    """Draw-independent horizon for the batched runner: the expected fastest
    helper's share from the mu/a choice set (certification re-runs with a
    doubled horizon when a draw lands above it)."""
    k = R + cfg.K(R)
    _mu, _a, w = class_weights(cfg)
    return _bucketed_horizon(cfg, float(w.max() / (cfg.N * w.mean())), k)
