"""Scenario model of the paper's §6 simulations: configs, random draws,
completion-time and efficiency extraction, and horizon heuristics.

A collector offloads fountain-coded packets to ``N`` heterogeneous helpers
over links with random per-packet rates; helper ``n`` computes packet ``i``
in ``beta_{n,i}`` (Scenario 1: i.i.d. shifted-exponential per packet;
Scenario 2: one draw per helper).  The completion time is when the collector
has received ``R+K`` computed packets.  The per-packet timeline itself is
simulated by :func:`repro_torch.core.engine.policy_stream`.

Churn (``ScenarioConfig(churn=ChurnConfig(...))``): time is divided into
phases of ``period`` seconds (``n_phases`` distinct phases, wrapping after
``n_phases * period``).  Per-helper outages (whole phases, or intervals of a
geometric or log-normal duration), Gilbert–Elliott burst loss per packet,
correlated whole-cell outages, i.i.d. ``drop_prob`` loss and slowdown
phases lose or stretch packets; the collector reacts with Algorithm 1
lines 13-14 (``Policy.on_timeout``).  A ``ChurnConfig`` with every loss
knob at zero is bit for bit the static model.

Transport (``rtt_dist != 'off'``): :func:`draw_dynamics` adds the
feedback-RTT tables of :mod:`repro_torch.core.transport`, drawn after every
churn table.  Fleets (:meth:`repro_torch.core.engine.Engine.run_fleet`)
draw each tenant's packet tables with :func:`draw_task_tables` and share
the helper-state processes (:func:`stack_fleet_dynamics`).

Port of ``repro.core.simulator``.  Every table carries a leading rep
dimension ``(B, N[, M])`` in place of the reference's ``vmap`` (a fleet's
per-tenant tables ``(B, T, N, M)``), and is float32 as the reference's are
(JAX runs with x64 off).  Draws use an
explicit ``torch.Generator``: they follow the reference's distributions but
not its bits (tests compare moments, and inject JAX-drawn tables through
:mod:`repro_torch.interop` where bits matter).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import ccp as ccp_mod
from . import theory
from .transport import RTT_DISTS, draw_rtt_tables

__all__ = [
    "ChurnConfig",
    "RTT_DISTS",
    "ScenarioConfig",
    "FLEET_PER_TASK",
    "draw_dynamics",
    "draw_helpers",
    "draw_packet_tables",
    "draw_task_tables",
    "stack_fleet_dynamics",
    "class_weights",
    "completion_time",
    "efficiency_measured",
]


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Time-varying resource model (see the module docstring).

    period:     phase length in seconds; helper states re-randomize each
                phase, so ``period`` sets the churn timescale.
    n_phases:   distinct phases drawn; the schedule wraps (mod) beyond that.
    p_down:     per-phase prob of a helper outage (packets sent to it are lost).
    p_slow:     per-phase prob a helper is degraded (mu_n / slowdown).
    slowdown:   service-rate divisor while degraded.
    drop_prob:  i.i.d. per-packet loss on top of outages.
    max_backoff: cap on the Alg.-1 line-13 multiplicative TTI backoff so a
                rejoining helper is re-probed within a bounded interval.
    outage_dist: outage-duration law for helper and cell outages: 'phase'
                (whole phases), 'geometric' (whole periods, mean
                ``outage_mean``) or 'lognormal' (continuous, mean
                ``outage_mean``, log-std ``outage_sigma``).
    outage_mean: mean outage duration in seconds for the duration laws.
    outage_sigma: log-std of the log-normal duration law.
    ge_p_bad:   Gilbert–Elliott good->bad transition prob per packet (0
                disables the chain).  Each ``ge_*`` knob is a scalar or a
                tuple of per-class values; tuples share one length C,
                scalars broadcast, and every helper draws a class uniformly
                in :func:`draw_dynamics`.
    ge_p_good:  GE bad->good transition prob per packet.
    ge_loss_good / ge_loss_bad: per-packet loss prob in each GE state.
    p_cell:     per-phase prob a correlated whole-cell outage event starts.
    cell_frac:  prob each helper belongs to a given cell event.
    rtt_dist:   feedback-RTT regime of the transport layer
                (:mod:`repro_torch.core.transport`): 'off' (the idealized
                zero-latency control plane), 'fixed', 'lognormal'
                (jittered) or 'cell' (latency spikes).  When on, every
                StepCtx observation the policy sees is delayed by the
                sampled feedback RTT (doubled when the ACK itself is lost)
                while ground-truth completion stays time-exact;
                ``rtt_mean = 0`` is bit for bit the idealized engine.
    rtt_mean:   mean feedback RTT in seconds.
    rtt_sigma:  log-std of the 'lognormal' per-packet jitter.
    rtt_spike_prob / rtt_spike_scale: 'cell' regime: per-packet prob of a
                latency spike and its multiplier on the base RTT.
    rtt_het:    per-helper base-RTT heterogeneity: bases are uniform in
                ``rtt_mean * [1 - rtt_het, 1 + rtt_het]``.
    """

    period: float = 5.0
    n_phases: int = 16
    p_down: float = 0.0
    p_slow: float = 0.0
    slowdown: float = 4.0
    drop_prob: float = 0.0
    max_backoff: float = 8.0
    outage_dist: str = "phase"
    outage_mean: float = 5.0
    outage_sigma: float = 0.5
    ge_p_bad: float | Tuple[float, ...] = 0.0
    ge_p_good: float | Tuple[float, ...] = 0.25
    ge_loss_good: float | Tuple[float, ...] = 0.0
    ge_loss_bad: float | Tuple[float, ...] = 1.0
    p_cell: float = 0.0
    cell_frac: float = 0.5
    rtt_dist: str = "off"
    rtt_mean: float = 0.0
    rtt_sigma: float = 0.5
    rtt_spike_prob: float = 0.05
    rtt_spike_scale: float = 10.0
    rtt_het: float = 0.0

    _GE_KNOBS = ("ge_p_bad", "ge_p_good", "ge_loss_good", "ge_loss_bad")

    def __post_init__(self):
        if self.outage_dist not in ("phase", "geometric", "lognormal"):
            raise ValueError(
                f"outage_dist must be 'phase', 'geometric' or 'lognormal', "
                f"got {self.outage_dist!r}"
            )
        if self.rtt_dist not in RTT_DISTS:
            raise ValueError(
                f"rtt_dist must be one of {RTT_DISTS}, got {self.rtt_dist!r}"
            )
        if self.rtt_mean < 0.0:
            raise ValueError(f"rtt_mean must be >= 0, got {self.rtt_mean!r}")
        if not 0.0 <= self.rtt_het <= 1.0:
            raise ValueError(
                f"rtt_het must be in [0, 1], got {self.rtt_het!r}")
        # Normalize list-valued GE knobs to (hashable) tuples and check the
        # per-class lengths agree.
        lengths = set()
        for k in self._GE_KNOBS:
            v = getattr(self, k)
            if isinstance(v, list):
                v = tuple(v)
                object.__setattr__(self, k, v)
            if isinstance(v, tuple):
                lengths.add(len(v))
        if len(lengths) > 1:
            raise ValueError(
                f"tuple-valued ge_* knobs must share one class count, got "
                f"lengths {sorted(lengths)}"
            )

    @property
    def ge_classes(self) -> int:
        """Number of heterogeneous GE classes (1 = homogeneous)."""
        for k in self._GE_KNOBS:
            v = getattr(self, k)
            if isinstance(v, tuple):
                return len(v)
        return 1

    def ge_class_params(self) -> np.ndarray:
        """(4, C) per-class (p_bad, p_good, loss_good, loss_bad) float64
        array with scalar knobs broadcast across the C classes."""
        c = self.ge_classes
        return np.stack([
            np.broadcast_to(np.asarray(getattr(self, k), dtype=np.float64), (c,))
            for k in self._GE_KNOBS
        ])

    @property
    def ge_enabled(self) -> bool:
        return float(np.max(self.ge_p_bad)) > 0.0

    @property
    def cell_enabled(self) -> bool:
        return self.p_cell > 0.0

    @property
    def ge_stationary_bad(self) -> float:
        """Stationary P(bad) of the GE chain (0 when disabled); for
        heterogeneous classes, the uniform-over-classes average."""
        pb, pg, _, _ = self.ge_class_params()
        denom = pb + pg
        return float(np.mean(np.where(denom > 0, pb / np.where(denom > 0, denom, 1.0), 0.0)))

    @property
    def ge_loss_rate(self) -> float:
        """Stationary marginal per-packet GE loss rate (class-averaged)."""
        pb_t, pg, lg, lb = self.ge_class_params()
        denom = pb_t + pg
        pb = np.where(denom > 0, pb_t / np.where(denom > 0, denom, 1.0), 0.0)
        return float(np.mean(pb * lb + (1.0 - pb) * lg))

    @property
    def rtt_enabled(self) -> bool:
        """True when the transport feedback-delay line is structurally on
        (``rtt_dist != 'off'``); with ``rtt_mean = 0`` the enabled path is
        still numerically the idealized engine, bit for bit."""
        return self.rtt_dist != "off"

    @property
    def neutral(self) -> bool:
        return (self.p_down == 0.0 and self.p_slow == 0.0
                and self.drop_prob == 0.0 and not self.ge_enabled
                and not self.cell_enabled
                and (not self.rtt_enabled or self.rtt_mean == 0.0))

    def static_key(self) -> tuple:
        """Hashable tuple of the *structural* knobs the engine loop
        specializes on (``engine.policy_stream``'s ``churn_static``)."""
        return (self.period, self.max_backoff, self.outage_dist,
                self.ge_enabled, self.cell_enabled, self.rtt_dist)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Paper §6 simulation setup.

    scenario: 1 (i.i.d. per-packet runtimes / Model I) or
              2 (one runtime draw per helper / Model II).
    a_mode:   'const' -> a_n = a_const;  'inv_mu' -> a_n = 1/mu_n.
    mu_choices: helper speeds drawn uniformly from this set.
    rate_lo/rate_hi: per-helper mean link rate bounds (bits/sec); per-packet
      rates are Poisson with that mean (in Mbps), floored at 0.5 Mbps.
    churn: optional :class:`ChurnConfig`; None reproduces the paper's static
      setup exactly.
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
    churn: Optional[ChurnConfig] = None

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


def _bernoulli(gen: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < p


def _draw_durations(gen: torch.Generator, ch: ChurnConfig, shape) -> torch.Tensor:
    """Outage durations (seconds, float32) under ``ch.outage_dist``.

    'phase' -> exactly one period; 'geometric' -> whole periods,
    Geometric(period/outage_mean) on {1, 2, ...}, mean
    ``max(outage_mean, period)``; 'lognormal' -> continuous, mean
    ``outage_mean``, log-std ``outage_sigma``."""
    dev = gen.device
    if ch.outage_dist == "geometric":
        p = min(1.0, ch.period / max(ch.outage_mean, ch.period))
        if p >= 1.0:  # geometric_ takes p in (0, 1); at p = 1 every draw is 1
            return torch.full(shape, ch.period, device=dev)
        k = torch.empty(shape, device=dev).geometric_(p, generator=gen)
        return k * ch.period
    if ch.outage_dist == "lognormal":
        mu_log = float(np.log(ch.outage_mean) - 0.5 * ch.outage_sigma ** 2)
        z = torch.randn(shape, generator=gen, device=dev)
        return torch.exp(mu_log + ch.outage_sigma * z)
    return torch.full(shape, ch.period, device=dev)


def draw_dynamics(gen: torch.Generator, cfg: ScenarioConfig, reps: int, M: int) -> dict:
    """Churn tables for ``reps`` reps (see the module docstring).

    Always: ``drop`` (B, N, M) i.i.d. per-packet loss and ``speed``
    (B, N, P) per-phase service-rate factor (1 normal, 1/slowdown degraded).
    Per-helper outages: ``up`` (B, N, P) phase table when
    ``outage_dist='phase'``, else ``out_start``/``out_end`` (B, N, P)
    absolute intervals inside the wrapping window ``n_phases * period``.
    When enabled: ``cell_start``/``cell_end`` (B, P) and ``cell_mask``
    (B, N, P) correlated-outage events, and ``ge_bad0`` (B, N) initial
    states, ``ge_u_trans``/``ge_u_loss`` (B, N, M) uniforms and
    ``ge_params`` for the Gilbert–Elliott chain: (B, 4) float32
    (p_bad, p_good, loss_good, loss_bad), or (B, 4, N) when any ``ge_*``
    knob is a per-class tuple (each helper draws a class uniformly).
    With the transport layer on (``rtt_dist != 'off'``): ``rtt_base``
    (B, N), ``rtt_jit``/``ack_u`` (B, N, M) and ``ack_p_drop`` (B,) float32
    (:func:`repro_torch.core.transport.draw_rtt_tables`), drawn after every
    table above, so turning transport on never changes a churn draw."""
    ch = cfg.churn
    dev = gen.device
    B, N, P = reps, cfg.N, ch.n_phases
    dyn = dict(
        drop=_bernoulli(gen, ch.drop_prob, (B, N, M)),
        speed=torch.where(_bernoulli(gen, ch.p_slow, (B, N, P)),
                          1.0 / ch.slowdown, 1.0),
    )
    if ch.outage_dist == "phase":
        dyn["up"] = ~_bernoulli(gen, ch.p_down, (B, N, P))
    else:
        ev = _bernoulli(gen, ch.p_down, (B, N, P))
        start = (torch.arange(P, device=dev) * ch.period).to(torch.float32).expand(B, N, P)
        dur = _draw_durations(gen, ch, (B, N, P))
        dyn["out_start"] = torch.where(ev, start, torch.inf)
        dyn["out_end"] = torch.where(ev, start + dur, -torch.inf)
    if ch.cell_enabled:
        ev = _bernoulli(gen, ch.p_cell, (B, P))
        start = (torch.arange(P, device=dev) * ch.period).to(torch.float32) + \
            torch.rand((B, P), generator=gen, device=dev) * ch.period
        dur = _draw_durations(gen, ch, (B, P))
        dyn["cell_start"] = torch.where(ev, start, torch.inf)
        dyn["cell_end"] = torch.where(ev, start + dur, -torch.inf)
        dyn["cell_mask"] = _bernoulli(gen, ch.cell_frac, (B, N, P))
    if ch.ge_enabled:
        per_class = torch.as_tensor(ch.ge_class_params(), dtype=torch.float32, device=dev)
        if ch.ge_classes == 1:
            dyn["ge_bad0"] = _bernoulli(gen, ch.ge_stationary_bad, (B, N))
            dyn["ge_params"] = per_class[:, 0].expand(B, 4).contiguous()
        else:
            # Heterogeneous GE: each helper draws a fader class uniformly;
            # the chain starts in its per-helper stationary distribution.
            cls = torch.randint(ch.ge_classes, (B, N), generator=gen, device=dev)
            per = per_class[:, cls].permute(1, 0, 2).contiguous()  # (B, 4, N)
            pb, pg = per[:, 0], per[:, 1]
            denom = pb + pg
            stat = torch.where(denom > 0, pb / torch.where(denom > 0, denom, 1.0), 0.0)
            dyn["ge_bad0"] = torch.rand((B, N), generator=gen, device=dev) < stat
            dyn["ge_params"] = per
        dyn["ge_u_trans"] = torch.rand((B, N, M), generator=gen, device=dev)
        dyn["ge_u_loss"] = torch.rand((B, N, M), generator=gen, device=dev)
    if ch.rtt_enabled:
        dyn.update(draw_rtt_tables(gen, ch, B, N, M))
        dyn["ack_p_drop"] = torch.full((B,), float(np.float32(ch.drop_prob)), device=dev)
    return dyn


#: The per-packet dynamics a fleet draws per tenant (tenants send distinct
#: packets); every other table is a helper-state process, shared.
FLEET_PER_TASK = ("drop", "ge_u_loss", "rtt_jit", "ack_u")


def draw_task_tables(gen: torch.Generator, cfg: ScenarioConfig, mu, a, rate,
                     M: int, R: int):
    """One tenant's packet tables and, under churn, its dynamics, drawn in
    the order :func:`repro_torch.core.engine.draw_tables` draws them after
    the helpers: so a fleet's task 0 draws exactly the single-task tables
    (the equivalence spine of ``Engine.run_fleet``).  Returns
    ``(beta, d_up, d_ack, d_down, dyn)``, ``dyn`` None when static."""
    tabs = draw_packet_tables(gen, cfg, mu, a, rate, M, R)
    dyn = None if cfg.churn is None else draw_dynamics(gen, cfg, mu.shape[0], M)
    return (*tabs, dyn)


def stack_fleet_dynamics(per_task) -> dict:
    """Fleet churn tables from each tenant's :func:`draw_dynamics` output:
    the helper-state processes (outage phases or intervals, slowdown
    phases, cell events, the Gilbert–Elliott chain's start and transition
    draws, ``rtt_base``, ``ack_p_drop``) are task 0's, shared by every
    tenant (a helper that is down is down for everyone); the per-packet
    draws :data:`FLEET_PER_TASK` gain a task axis, (B, T, N, M)."""
    dyn = dict(per_task[0])
    for k in FLEET_PER_TASK:
        if k in dyn:
            dyn[k] = torch.stack([d[k] for d in per_task], dim=1)
    return dyn


def _phase_lookup(table: torch.Tensor, t: torch.Tensor, period: float) -> torch.Tensor:
    """table (B, N, P) indexed by the wrapping phase of times t (B, N).
    ``torch.div(..., rounding_mode="floor")`` is ``jnp.floor_divide``'s
    float algorithm (CPython's float divmod), so the phases agree bit for
    bit, also at exact multiples of ``period``."""
    P = table.shape[-1]
    ph = torch.remainder(torch.div(t, period, rounding_mode="floor").to(torch.int32), P)
    return torch.gather(table, -1, ph[..., None].long())[..., 0]


def _interval_hit(start: torch.Tensor, end: torch.Tensor, t: torch.Tensor,
                  window: float) -> torch.Tensor:
    """Per-interval membership of times t (B, N) in [start, end) intervals,
    with the schedule wrapping every ``window`` seconds.  Returns (B, N, P).

    start/end are (B, N, P) per-helper intervals or (B, P) shared event
    times, broadcast over the helper axis.  Intervals are laid out in
    absolute time inside [0, window); one whose end spills past the window
    also covers the wrapped tail [0, end - window)."""
    tm = torch.remainder(t, window)[..., None]
    if start.dim() == 2:  # shared cell events
        start, end = start[:, None, :], end[:, None, :]
    return ((tm >= start) & (tm < end)) | (tm < (end - window))


# ---------------------------------------------------------------------------
# Completion-time + efficiency extraction
# ---------------------------------------------------------------------------

def completion_time(tr: torch.Tensor, k: int,
                    tx_end: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per rep, the time when the k-th computed packet reaches the collector.

    tr: (B, N, M).  Returns (T, valid), each (B,): ``valid`` is False if the
    per-helper horizon M was too short to certify T (some helper might have
    contributed more packets by T than were simulated) — the caller re-runs
    with a larger M.  With ``tx_end`` (B, N), the send time of the first
    unsimulated packet, certification is "no helper would even have *sent*
    packet M+1 by T".  With fewer than k packets simulated (N*M < k) the
    index clamps to the last packet and the certification is unchanged, as
    in the reference (whose ``flat[k - 1]`` clamps the same way).
    """
    flat = torch.sort(tr.reshape(tr.shape[0], -1), dim=-1).values
    t = flat[:, min(k, flat.shape[1]) - 1]
    if tx_end is not None:
        valid = torch.isfinite(t) & (t <= tx_end.amin(dim=-1))
    else:
        valid = t <= tr[:, :, -1].amin(dim=-1)
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

def _m_cap(cfg: ScenarioConfig, kk: int) -> int:
    # Static: every helper streams back-to-back, so M = R+K always certifies.
    # Under churn a helper's M packets can include losses: leave headroom.
    return kk if cfg.churn is None else 4 * kk


def _bucketed_horizon(cfg: ScenarioConfig, share: float, k: int) -> int:
    """~3x the fastest helper's fair share, bucketed to a power of two,
    capped at :func:`_m_cap`."""
    m = int(np.ceil(3.0 * k * share)) + 64
    bucket = 1 << int(np.ceil(np.log2(max(m, 64))))
    return min(bucket, _m_cap(cfg, k))


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
