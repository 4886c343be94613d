"""Policy-driven Monte-Carlo engine: one entry point for every offloading
policy (static path).

The engine owns the *scenario dynamics* — helper draws and per-packet
link/compute timing — and threads a
:class:`~repro_torch.core.policies.base.Policy` through a per-packet loop:
the policy decides pacing (``next_load``), receipt handling
(``on_computed``) and the completion rule (``finalize``).

Port of the single-task static path of ``repro.core.engine``.  The
reference's ``vmap`` over reps becomes a leading rep dimension ``(B, N, M)``
and its ``lax.scan`` a Python loop over packet steps.  A rep is split into
"draw tables" (:func:`draw_tables`, on a ``torch.Generator``) and "simulate
from tables" (:func:`simulate`), so tests can feed the port tables that the
reference drew and compare the traces.  Churn, the in-scan decoder, the
transport line, fleets and ``shard=True`` are later slices (ROADMAP).

Typical usage::

    from repro_torch.core import engine
    from repro_torch.configs.ccp_paper import FIG3

    res = engine.Engine(device="cuda").run(FIG3[1], "ccp", reps=200, R=2000)
    res.T            # (reps,) completion times
    res.efficiency   # (reps, N) per-helper measured efficiency
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import _device
from . import ccp as ccp_mod
from . import policies as policies_mod
from . import simulator as sim

__all__ = ["Engine", "RunResult", "Tables", "policy_stream", "draw_tables",
           "simulate"]


def _as_policy(policy) -> policies_mod.Policy:
    if isinstance(policy, str):
        return policies_mod.get(policy)  # unknown names raise with known list
    if not isinstance(policy, policies_mod.Policy):
        raise TypeError(
            "policy must be a registry name or a Policy instance, got "
            f"{type(policy).__name__}; known policies: "
            f"{list(policies_mod.names())}"
        )
    return policy


def _check_R(R) -> None:
    if isinstance(R, bool) or not isinstance(R, (int, np.integer)) or R <= 0:
        raise ValueError(
            f"R must be a positive int (source packets per task), got {R!r}"
        )


# ---------------------------------------------------------------------------
# The per-helper timeline loop (scenario dynamics x policy hooks)
# ---------------------------------------------------------------------------

def policy_stream(beta, d_up, d_ack, d_down, policy, cfg_static, aux=None):
    """Simulate M packets on every helper of every rep under ``policy``.

    beta/d_up/d_ack/d_down: (B, N, M) float32 tables.  cfg_static: the
    (Bx, Br, Back, alpha) tuple of :class:`~repro_torch.core.ccp.CCPConfig`.
    Returns the dict of (B, N, M) trace tensors (tr, idle, tx, arrive,
    beta, lost, backoff) plus ``tx_end`` (B, N) — the send time of the first
    unsimulated packet.

    Timing model per packet (helper n, packet i):
      arrive_i = tx_i + d_up_i                      (uplink)
      start_i  = max(arrive_i, done_{i-1})          (FIFO helper queue)
      done_i   = start_i + beta_i
      Tr_i     = done_i + d_down_i                  (result downlink)
      RTTack_i = d_up_i + d_ack_i                   (receipt ACK, measured)
      idle_i   = max(0, arrive_i - done_{i-1})      (helper under-utilization)
    """
    Bx, Br, Back, alpha = cfg_static
    cfg = ccp_mod.CCPConfig(Bx=Bx, Br=Br, Back=Back, alpha=alpha)
    B, N, M = beta.shape
    dev = beta.device
    aux = {} if aux is None else aux
    zero = torch.tensor(0.0)  # 0-d CPU scalar operand of torch.maximum
    tx = torch.zeros((B, N), device=dev)  # Tx_{n,1} = 0
    done_prev = torch.zeros((B, N), device=dev)
    tr_prev = torch.zeros((B, N), device=dev)
    pstate = policy.init((B, N), dev)
    lost = torch.zeros((B, N), dtype=torch.bool, device=dev)
    ones = torch.ones((B, N), device=dev)
    outs = {k: [] for k in ("tr", "idle", "tx", "arrive", "beta", "backoff")}

    for i in range(M):
        beta_i, up = beta[..., i], d_up[..., i]
        sent = torch.isfinite(tx)
        arrive = tx + up
        start = torch.maximum(arrive, done_prev)
        received = ~lost & sent
        done = start + beta_i  # a static-path packet is never lost
        tr_ok = done + d_down[..., i]
        tr = torch.where(received, tr_ok, torch.inf)
        idle = torch.where(received, torch.maximum(arrive - done_prev, zero), 0.0)
        rtt_ack = up + d_ack[..., i]
        ctx = policies_mod.StepCtx(
            i=i, n=N, tx=tx, arrive=arrive, start=start, beta=beta_i,
            tr_ok=tr_ok, lost=lost, received=received, rtt_ack=rtt_ack,
            d_up=up, d_down=d_down[..., i], d_ack=d_ack[..., i],
            tr_prev=tr_prev, cfg=cfg, aux=aux,
        )
        pstate = policy.on_computed(pstate, ctx)
        tx_next = policy.next_load(pstate, ctx)
        b = policy.backoff(pstate)
        for k, v in (("tr", tr), ("idle", idle), ("tx", tx), ("arrive", arrive),
                     ("beta", torch.where(sent, beta_i, 0.0)),
                     ("backoff", ones if b is None else b)):
            outs[k].append(v)
        tr_prev = torch.where(received, tr_ok, tr_prev)
        tx, done_prev = tx_next, done

    res = {k: torch.stack(v, dim=-1) for k, v in outs.items()}
    res["lost"] = torch.zeros((B, N, M), dtype=torch.bool, device=dev)
    res["tx_end"] = tx
    return res


# ---------------------------------------------------------------------------
# One Monte-Carlo batch: draw tables, then simulate from them
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tables:
    """A batch's random draws: helper draws (B, N) and packet tables
    (B, N, M), float32 on one device."""

    mu: torch.Tensor
    a: torch.Tensor
    rate: torch.Tensor
    beta: torch.Tensor
    d_up: torch.Tensor
    d_ack: torch.Tensor
    d_down: torch.Tensor


def draw_tables(gen: torch.Generator, cfg, reps: int, R: int, M: int) -> Tables:
    """Draw a batch's helpers, then its packet tables, from ``gen``."""
    mu, a, rate = sim.draw_helpers(gen, cfg, reps)
    beta, d_up, d_ack, d_down = sim.draw_packet_tables(gen, cfg, mu, a, rate, M, R)
    return Tables(mu, a, rate, beta, d_up, d_ack, d_down)


def simulate(tables: Tables, cfg, R: int, policy) -> Dict[str, torch.Tensor]:
    """Run ``policy`` over drawn tables and extract every rep's completion
    time, certification and per-helper statistics."""
    policy = _as_policy(policy)
    c = cfg.ccp_cfg(R)
    aux = policy.prepare(cfg, R, c, tables.mu, tables.a, tables.rate)
    outs = policy_stream(tables.beta, tables.d_up, tables.d_ack, tables.d_down,
                         policy=policy, cfg_static=(c.Bx, c.Br, c.Back, c.alpha),
                         aux=aux)
    kk = R + cfg.K(R)
    t, valid = policy.finalize(outs, aux, cfg, R, kk)
    tr, idle, beta = outs["tr"], outs["idle"], outs["beta"]
    eff = sim.efficiency_measured(tr, idle, beta, t)
    r_n = (torch.isfinite(tr) & (tr <= t[:, None, None])).sum(dim=-1)
    # Loss rate over packets actually sent (0 on the static path).
    n_sent = torch.isfinite(outs["tx"]).sum(dim=-1)
    m_steps = outs["lost"].shape[-1]
    lost_frac = outs["lost"].float().mean(dim=-1) * (
        m_steps / torch.clamp_min(n_sent, 1))
    return dict(T=t, valid=valid, efficiency=eff, r_n=r_n, mu=tables.mu,
                a=tables.a, rate=tables.rate,
                max_backoff=outs["backoff"].amax(dim=-1), lost_frac=lost_frac)


def _m_cap(cfg, kk: int, policy) -> int:
    # Static: every helper streams back-to-back, so M = R+K always certifies.
    factor = policy.m_cap_factor
    return (1 if factor is None else factor) * kk


def _initial_m(base_m: int, cfg, R: int, kk: int, cap: int, policy,
               M_override: Optional[int]) -> int:
    """Starting horizon: the engine heuristic ``base_m``, clamped by the
    policy's ``horizon_hint`` and the cap.  Certification doubling
    backstops a hint that guessed low."""
    if M_override is not None:
        return min(M_override, cap)
    m = base_m
    hint = policy.horizon_hint(cfg, R, kk)
    if hint is not None:
        m = min(m, max(int(hint), 32))
    return min(m, cap)


# ---------------------------------------------------------------------------
# RunResult + Engine
# ---------------------------------------------------------------------------

_CORE_FIELDS = ("T", "valid", "efficiency", "r_n", "mu", "a", "rate",
                "max_backoff", "lost_frac")


@dataclasses.dataclass
class RunResult:
    """Structured result of ``Engine.run`` over B reps, as tensors on the
    run's device.

    T (B,) completion times; valid (B,) certification mask (False: the
    horizon cap was hit before the completion time could be certified —
    the rep MUST be dropped and counted, never averaged); efficiency /
    r_n / mu / a / rate / max_backoff / lost_frac (B, N) per-helper
    statistics; M the shared horizon actually used; policy the registry
    name.
    """

    T: torch.Tensor
    valid: torch.Tensor
    efficiency: torch.Tensor
    r_n: torch.Tensor
    mu: torch.Tensor
    a: torch.Tensor
    rate: torch.Tensor
    max_backoff: torch.Tensor
    lost_frac: torch.Tensor
    M: int
    policy: str

    def __getitem__(self, key):
        return self.as_dict()[key]

    def as_dict(self) -> Dict[str, object]:
        d = {f: getattr(self, f) for f in _CORE_FIELDS}
        d["M"] = self.M
        return d


def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        if seed.device.type != device.type:
            raise ValueError(f"generator on {seed.device}, engine on {device}")
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


class Engine:
    """Single entry point for policy-driven Monte-Carlo simulation.

    ``Engine(device).run(cfg, policy, reps, R, seed=...)`` draws ``reps``
    helper sets and packet tables on ``device`` (CUDA unless the caller
    names another) and simulates them all at once with one shared,
    power-of-two-bucketed horizon M.  If any rep is uncertified the horizon
    doubles and the batch is drawn again from the same generator state — the
    helper draw comes first, so it is unchanged — until every rep is
    certified or the cap is hit.
    """

    def __init__(self, device=None, shard: bool = False):
        if shard:
            raise NotImplementedError(
                "shard=True waits for a second card (ROADMAP: multi-GPU "
                "shard paths)")
        self.device = _device.resolve(device)

    def run(self, cfg, policy, reps: int, R: int, *,
            seed: Union[int, torch.Generator] = 0,
            M_override: Optional[int] = None) -> RunResult:
        """Run ``policy`` (a registry name or Policy instance) over ``reps``
        reps drawn from ``seed`` (an int or a ``torch.Generator`` on the
        engine's device); returns a :class:`RunResult`."""
        policy = _as_policy(policy)
        _check_R(R)
        if isinstance(reps, bool) or not isinstance(reps, (int, np.integer)) or reps <= 0:
            raise ValueError(f"reps must be a positive int, got {reps!r}")
        gen = _generator(seed, self.device)
        state = gen.get_state()
        kk = R + cfg.K(R)
        cap = _m_cap(cfg, kk, policy)
        M = _initial_m(sim._horizon_shared(cfg, R), cfg, R, kk, cap, policy,
                       M_override)
        for _ in range(8):
            gen.set_state(state)
            out = simulate(draw_tables(gen, cfg, reps, R, M), cfg, R, policy)
            if bool(out["valid"].all()) or M >= cap or M_override is not None:
                break
            M = min(M * 2, cap)
        return RunResult(M=M, policy=policy.name, **out)

    def run_one(self, cfg, policy, R: int, *,
                seed: Union[int, torch.Generator] = 0,
                M_override: Optional[int] = None) -> Dict[str, object]:
        """Single-rep runner with the horizon sized to this rep's helper
        draw; returns host values (numpy arrays, ``T`` a float, ``M``)."""
        policy = _as_policy(policy)
        _check_R(R)
        gen = _generator(seed, self.device)
        state = gen.get_state()
        mu, a, _rate = sim.draw_helpers(gen, cfg, 1)
        kk = R + cfg.K(R)
        cap = _m_cap(cfg, kk, policy)
        M = _initial_m(sim._horizon(cfg, mu[0].cpu().numpy(), a[0].cpu().numpy(), R),
                       cfg, R, kk, cap, policy, M_override)
        for _ in range(8):  # grow horizon until completion is certified
            gen.set_state(state)
            out = simulate(draw_tables(gen, cfg, 1, R, M), cfg, R, policy)
            if bool(out["valid"][0]) or M >= cap or M_override is not None:
                break
            M = min(M * 2, cap)
        res = {k: v[0].cpu().numpy() for k, v in out.items()}
        res["T"] = float(res["T"])
        res["M"] = M
        return res
