"""Policy-driven Monte-Carlo engine: one entry point for every offloading
policy.

The engine owns the *scenario dynamics* — helper draws, per-packet
link/compute timing and the churn loss processes (phase or interval
outages, Gilbert–Elliott burst loss, correlated cell outages, slowdowns) —
and threads a :class:`~repro_torch.core.policies.base.Policy` through a
per-packet loop: the policy decides pacing (``next_load``), receipt
handling (``on_computed``), loss reaction (``on_timeout``, under churn) and
the completion rule (``finalize``).  For a policy with ``uses_decoder`` the
loop also runs the incremental peeling decoder
(:mod:`repro_torch.core.decode`) on every step's arrivals.

Port of the single-task path of ``repro.core.engine``.  The reference's
``vmap`` over reps becomes a leading rep dimension ``(B, N, M)`` and its
``lax.scan`` a Python loop over packet steps.  A rep is split into "draw
tables" (:func:`draw_tables`, on a ``torch.Generator``) and "simulate from
tables" (:func:`simulate`), so tests can feed the port tables (and churn
dynamics) that the reference drew and compare the traces.  Under a
``ChurnConfig`` with ``rtt_dist != 'off'`` the loop threads the transport
feedback-delay line (:mod:`repro_torch.core.transport`): the policy hooks
see observed instants, the trace stays physical.  ``Engine.run_fleet`` runs
T tenants over one shared helper pool (:mod:`repro_torch.core.fleet`).
``Engine(shard=True)`` splits each batch's reps over a list of devices
(several cards, or one card several times) and joins the slices: per-rep
lanes never communicate, so the results are bitwise the unsharded run's.

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
from . import decode as decode_mod
from . import policies as policies_mod
from . import simulator as sim
from . import transport as transport_mod

__all__ = ["Engine", "FleetRunResult", "FleetTables", "RunResult", "Tables",
           "draw_fleet_tables", "draw_tables", "policy_stream", "simulate",
           "simulate_fleet"]


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


def _check_reps(reps) -> None:
    if isinstance(reps, bool) or not isinstance(reps, (int, np.integer)) or reps <= 0:
        raise ValueError(f"reps must be a positive int, got {reps!r}")


# ---------------------------------------------------------------------------
# Step kernels (the reference's shared step kernels of the single-task loop)
# ---------------------------------------------------------------------------

def _parse_churn_static(churn_static):
    """Unpack ``ChurnConfig.static_key()`` — the 6-tuple, the
    pre-transport 5-tuple, or the 2-tuple (period, max_backoff) of phase
    outages only, as the reference's direct ``policy_stream`` callers pass."""
    ge_on = cell_on = False
    outage_dist = "phase"
    rtt_dist = "off"
    if len(churn_static) == 2:
        period, max_backoff = churn_static
    elif len(churn_static) == 5:
        period, max_backoff, outage_dist, ge_on, cell_on = churn_static
    else:
        (period, max_backoff, outage_dist, ge_on, cell_on,
         rtt_dist) = churn_static
    return period, max_backoff, outage_dist, ge_on, cell_on, rtt_dist


def _churn_step(dyn, a, beta_x, drop, t_arr, t_sta, sent, *, period, window,
                outage_dist, cell_on):
    """Outage / slowdown / i.i.d.-drop evaluation for one step's (B, N)
    packets.

    Outage if the helper is down when the packet arrives or when it would
    start computing; degraded phases stretch the runtime (beta = a + eps/mu,
    so (beta - a)/speed rescales the random part).  ``t_arr``/``t_sta``
    must be clamped for unsent slots first, so no inf reaches the int cast
    of the phase lookup (undefined on CUDA)."""
    if outage_dist == "phase":
        is_up = (sim._phase_lookup(dyn["up"], t_arr, period)
                 & sim._phase_lookup(dyn["up"], t_sta, period))
    else:
        is_up = ~(sim._interval_hit(dyn["out_start"], dyn["out_end"], t_arr, window)
                  | sim._interval_hit(dyn["out_start"], dyn["out_end"], t_sta, window)
                  ).any(dim=-1)
    if cell_on:
        in_cell = dyn["cell_mask"] & (
            sim._interval_hit(dyn["cell_start"], dyn["cell_end"], t_arr, window)
            | sim._interval_hit(dyn["cell_start"], dyn["cell_end"], t_sta, window))
        is_up = is_up & ~in_cell.any(dim=-1)
    sp = sim._phase_lookup(dyn["speed"], t_sta, period)
    beta_i = torch.where(sp == 1.0, beta_x, a + (beta_x - a) / sp)
    lost = (drop | ~is_up) & sent
    return beta_i, lost


def _ge_params(ge_params):
    """(p_bad, p_good, loss_good, loss_bad), each broadcastable against
    (B, N): ``ge_params`` is (B, 4) (one class) or (B, 4, N) (per helper).
    float32, so the comparisons below round as the reference's do."""
    if ge_params.dim() == 2:
        return tuple(ge_params[:, k, None] for k in range(4))
    return tuple(ge_params[:, k] for k in range(4))


def _ge_step(bad, ge_params, u_trans, u_loss, sent):
    """Gilbert–Elliott: loss by the current state, then the per-packet state
    transition (the chain advances even for packets already lost to an
    outage: the radio fades regardless).  ``ge_params`` from
    :func:`_ge_params`.  ``u_loss``/``sent`` may carry a tenant axis,
    (B, T, N) in a fleet: one chain per helper, shared, and a loss draw per
    tenant; ``bad``/``u_trans`` stay (B, N)."""
    p_bad, p_good, l_good, l_bad = ge_params
    threshold = torch.where(bad, l_bad, l_good)
    if u_loss.dim() > threshold.dim():
        threshold = threshold[:, None]
    lost = (u_loss < threshold) & sent
    bad_next = torch.where(bad, u_trans >= p_good, u_trans < p_bad)
    return lost, bad_next


def _transport_step(dyn, i: int, ge_bad=None, ge_par=None):
    """Observation delay of step ``i``'s feedback (transport layer on): the
    sampled feedback RTT ``rtt_base * rtt_jit``, doubled when the ACK is
    lost, composed with the Gilbert–Elliott state that governs this step's
    data loss (``ge_bad`` None when the chain is off).  In a fleet
    ``rtt_jit``/``ack_u`` are (B, T, N, M) and meet the shared (B, N) base
    RTT and chain state."""
    jit, ack_u = dyn["rtt_jit"][..., i], dyn["ack_u"][..., i]
    base, p_drop = dyn["rtt_base"], dyn["ack_p_drop"][:, None]
    if jit.dim() == 3:
        base, p_drop = base[:, None], p_drop[:, None]
        if ge_bad is not None:
            ge_bad, ge_par = ge_bad[:, None], tuple(g[:, None] for g in ge_par)
    return transport_mod.observation_delay(base * jit, ack_u, p_drop,
                                           ge_bad=ge_bad, ge_params=ge_par)


def _hook_step(policy, pstate, ctx, churn: bool):
    """One policy-hook round: receipt handling, pacing, and — under churn —
    the loss reaction, applied as ``where(lost, tx_retx, tx_next)``."""
    pstate = policy.on_computed(pstate, ctx)
    tx_next = policy.next_load(pstate, ctx)
    if churn:
        pstate, tx_retx = policy.on_timeout(pstate, ctx, tx_next)
        tx_next = torch.where(ctx.lost, tx_retx, tx_next)
    return pstate, tx_next, policy.backoff(pstate)


def _send_time_ids(sym_next, tx, sent):
    """Send-time coded-symbol assignment: rank each rep's sends of this step
    by their send instant (ties -> helper index, by a stable sort, as
    ``jnp.argsort`` is) and hand out the next unissued global ids in that
    order.  sym_next (B,) int32; tx/sent (B, N).  Unsent slots consume
    nothing; their placeholder ids are never absorbed."""
    order = torch.argsort(torch.where(sent, tx, torch.inf), dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1).to(torch.int32)
    return sym_next[:, None] + rank, sym_next + sent.sum(dim=-1, dtype=torch.int32)


def _decode_step(dec, t_hi, t_done, tables, ids, received, tr_ok):
    """Absorb this step's result arrivals into the peeling decoder and keep
    the real-time decode bound: every absorbed result has arrived by
    ``t_hi``, so when ``done`` first fires the collector provably holds a
    decodable set by then."""
    dec = decode_mod.absorb(dec, tables, ids, received)
    t_hi = torch.maximum(t_hi, torch.where(received, tr_ok, 0.0).amax(dim=-1))
    t_done = torch.where(dec["done"] & ~torch.isfinite(t_done), t_hi, t_done)
    return dec, t_hi, t_done


# ---------------------------------------------------------------------------
# The per-helper timeline loop (scenario dynamics x policy hooks)
# ---------------------------------------------------------------------------

def policy_stream(beta, d_up, d_ack, d_down, policy, cfg_static,
                  churn_static=None, dyn=None, a=None, aux=None):
    """Simulate M packets on every helper of every rep under ``policy``.

    beta/d_up/d_ack/d_down: (B, N, M) float32 tables.  cfg_static: the
    (Bx, Br, Back, alpha) tuple of :class:`~repro_torch.core.ccp.CCPConfig`.
    churn_static: ``ChurnConfig.static_key()`` (or the reference's 5-tuple
    or (period, max_backoff) 2-tuple of phase outages only), or None for
    the static paper model; with it, ``dyn`` (from
    :func:`repro_torch.core.simulator.draw_dynamics`, or
    :func:`repro_torch.interop.dynamics_from_numpy`) and the runtime
    offsets ``a`` (B, N) must be given.  aux: ``policy.prepare()`` output.
    Returns ``(outs, psummary)``: ``outs`` is the dict of (B, N, M) trace
    tensors (tr, idle, tx, arrive, beta, lost, backoff and, for a decoder
    policy, ``sym_id``, the global coded id each send carried) plus
    ``tx_end`` (B, N) — the send time of the first unsimulated packet;
    ``psummary`` is ``policy.summary(final_state)``, with the decoder's
    final ``dec_count`` and ``dec_done`` (B,) for a decoder policy.

    A churn_static whose ``rtt_dist`` is not 'off' switches on the
    transport feedback-delay line (``dyn`` then carries ``rtt_base``,
    ``rtt_jit``, ``ack_u`` and ``ack_p_drop``): the hooks and the decoder
    see *observed* instants (``ctx.tr_ok``, ``ctx.rtt_ack``, ``ctx.tr_prev``
    and ``decode_t_done`` shifted by the sampled feedback delay) while the
    returned trace stays physical.

    Timing model per packet (helper n, packet i):
      arrive_i = tx_i + d_up_i                      (uplink)
      start_i  = max(arrive_i, done_{i-1})          (FIFO helper queue)
      done_i   = start_i + beta_i                   (done_{i-1} if lost)
      Tr_i     = done_i + d_down_i                  (inf if lost)
      RTTack_i = d_up_i + d_ack_i                   (receipt ACK, measured)
      idle_i   = max(0, arrive_i - done_{i-1})      (helper under-utilization)

    The static path (``churn_static=None``) runs none of the churn branch's
    operations.
    """
    Bx, Br, Back, alpha = cfg_static
    cfg = ccp_mod.CCPConfig(Bx=Bx, Br=Br, Back=Back, alpha=alpha)
    B, N, M = beta.shape
    dev = beta.device
    aux = {} if aux is None else aux
    churn = churn_static is not None
    ge_on = rtt_on = False
    ge_bad = ge_par = None
    max_backoff = None
    if churn:
        (period, max_backoff, outage_dist, ge_on,
         cell_on, rtt_dist) = _parse_churn_static(churn_static)
        window = period * dyn["speed"].shape[-1]
        rtt_on = rtt_dist != "off"
        if ge_on:
            ge_bad, ge_par = dyn["ge_bad0"], _ge_params(dyn["ge_params"])
    zero = torch.tensor(0.0)  # 0-d CPU scalar operand of torch.maximum
    tx = torch.zeros((B, N), device=dev)  # Tx_{n,1} = 0
    done_prev = torch.zeros((B, N), device=dev)
    tr_prev = torch.zeros((B, N), device=dev)
    pstate = policy.init((B, N), dev)
    lost = torch.zeros((B, N), dtype=torch.bool, device=dev)  # static: never lost
    ones = torch.ones((B, N), device=dev)
    outs = {k: [] for k in ("tr", "idle", "tx", "arrive", "beta", "backoff")}
    if churn:
        outs["lost"] = []
    use_dec = bool(policy.uses_decoder)
    if use_dec:
        # The incremental peeling decoder rides the loop: prepare() put the
        # pool tables and the zero state under aux["decoder"].
        tables = aux["decoder"]["tables"]
        dec = aux["decoder"]["state0"]
        t_hi = torch.zeros((B,), device=dev)               # max received tr so far
        t_done = torch.full((B,), torch.inf, device=dev)   # t_hi when done fired
        sym_next = torch.zeros((B,), dtype=torch.int32, device=dev)  # next unissued id
        outs["sym_id"] = []

    for i in range(M):
        beta_i, up = beta[..., i], d_up[..., i]
        # A policy may stop a helper's stream by emitting tx = +inf; unsent
        # packets are non-events: no loss, no idle, no receipt.
        sent = torch.isfinite(tx)
        arrive = tx + up
        start = torch.maximum(arrive, done_prev)
        ge_now = ge_bad  # the chain state that governs this step's losses
        if churn:
            # Churn lookups run on clamped times: no inf reaches an index.
            t_arr = torch.where(sent, arrive, 0.0)
            t_sta = torch.where(sent, start, 0.0)
            beta_i, lost = _churn_step(
                dyn, a, beta_i, dyn["drop"][..., i], t_arr, t_sta, sent,
                period=period, window=window, outage_dist=outage_dist,
                cell_on=cell_on)
            if ge_on:
                lost_ge, ge_bad = _ge_step(ge_bad, ge_par, dyn["ge_u_trans"][..., i],
                                           dyn["ge_u_loss"][..., i], sent)
                lost = lost | lost_ge
        received = ~lost & sent
        done = start + beta_i
        tr_ok = done + d_down[..., i]
        if churn:
            # A lost packet never occupies the helper nor reaches the collector.
            done = torch.where(lost, done_prev, done)
        tr = torch.where(received, tr_ok, torch.inf)
        idle = torch.where(received, torch.maximum(arrive - done_prev, zero), 0.0)
        rtt_ack = up + d_ack[..., i]
        if rtt_on:
            # The transport delay line: the physics above is final; what
            # follows (decoder absorb, hooks) runs on the observed instants.
            # At rtt_mean = 0 the delay is exactly 0.0: bitwise the idealized
            # loop.
            delay = _transport_step(dyn, i, ge_now, ge_par)
            tr_obs, rtt_obs = tr_ok + delay, rtt_ack + delay
        else:
            tr_obs, rtt_obs = tr_ok, rtt_ack
        dec_kw = {}
        if use_dec:
            # Absorb this step's arrivals before the hooks run: the feedback
            # a policy sees at step i is everything an eagerly decoding
            # collector has recovered from packets 0..i.  decode_t_done is
            # the collector-observed bound (tr_obs).
            ids, sym_next = _send_time_ids(sym_next, tx, sent)
            dec, t_hi, t_done = _decode_step(dec, t_hi, t_done, tables, ids,
                                             received, tr_obs)
            dec_kw = dict(decoded_count=dec["count"], ripple=dec["ripple"],
                          decode_done=dec["done"], decode_t_done=t_done)
            outs["sym_id"].append(ids)
        ctx = policies_mod.StepCtx(
            i=i, n=N, tx=tx, arrive=arrive, start=start, beta=beta_i,
            tr_ok=tr_obs, lost=lost, received=received, rtt_ack=rtt_obs,
            d_up=up, d_down=d_down[..., i], d_ack=d_ack[..., i],
            tr_prev=tr_prev, cfg=cfg, aux=aux, max_backoff=max_backoff, **dec_kw,
        )
        pstate, tx_next, b = _hook_step(policy, pstate, ctx, churn)
        for k, v in (("tr", tr), ("idle", idle), ("tx", tx), ("arrive", arrive),
                     ("beta", torch.where(sent, beta_i, 0.0)),
                     ("backoff", ones if b is None else b)):
            outs[k].append(v)
        if churn:
            outs["lost"].append(lost)
        tr_prev = torch.where(received, tr_obs, tr_prev)
        tx, done_prev = tx_next, done

    res = {k: torch.stack(v, dim=-1) for k, v in outs.items()}
    if not churn:
        res["lost"] = torch.zeros((B, N, M), dtype=torch.bool, device=dev)
    res["tx_end"] = tx
    psum = policy.summary(pstate)
    if use_dec:
        # The end-of-horizon decoder state beside the policy's own summary
        # (-> RunResult.extras dec_count / dec_done).
        psum = dict(psum, dec_count=dec["count"], dec_done=dec["done"])
    return res, psum


# ---------------------------------------------------------------------------
# One Monte-Carlo batch: draw tables, then simulate from them
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tables:
    """A batch's random draws: helper draws (B, N) and packet tables
    (B, N, M), float32 on one device, and under churn the dynamics of
    :func:`repro_torch.core.simulator.draw_dynamics` (None when static)."""

    mu: torch.Tensor
    a: torch.Tensor
    rate: torch.Tensor
    beta: torch.Tensor
    d_up: torch.Tensor
    d_ack: torch.Tensor
    d_down: torch.Tensor
    dyn: Optional[dict] = None

    def to(self, device) -> "Tables":
        """The same tables (and dynamics) on ``device``."""
        return _map_tables(self, lambda t: t.to(device))

    def take(self, reps: torch.Tensor) -> "Tables":
        """The reps ``reps`` (an index tensor on the tables' device)."""
        return _map_tables(self, lambda t: t.index_select(0, reps))


def _map_tables(tables, fn):
    """``fn`` over every tensor of a :class:`Tables` or :class:`FleetTables`
    (each leads with the rep dimension), dynamics included."""
    moved = {f.name: fn(getattr(tables, f.name))
             for f in dataclasses.fields(tables) if f.name != "dyn"}
    dyn = None if tables.dyn is None else {k: fn(v) for k, v in tables.dyn.items()}
    return type(tables)(**moved, dyn=dyn)


def draw_tables(gen: torch.Generator, cfg, reps: int, R: int, M: int) -> Tables:
    """Draw a batch's helpers, then its packet tables, then (under churn)
    its dynamics, from ``gen``.  The dynamics come last, so a static and a
    churn config draw the same helpers and packet tables from one seed."""
    mu, a, rate = sim.draw_helpers(gen, cfg, reps)
    beta, d_up, d_ack, d_down = sim.draw_packet_tables(gen, cfg, mu, a, rate, M, R)
    dyn = None if cfg.churn is None else sim.draw_dynamics(gen, cfg, reps, M)
    return Tables(mu, a, rate, beta, d_up, d_ack, d_down, dyn)


def _task_stats(outs, aux, cfg, R: int, policy, tx_end) -> Dict[str, torch.Tensor]:
    """Every row's completion time, certification and per-helper statistics
    from the loop's (rows, N, M) traces: the extraction of the reference's
    ``_sim_one`` (and, per task, of its ``_fleet_one``)."""
    kk = R + cfg.K(R)
    t, valid = policy.finalize(outs, aux, cfg, R, kk, tx_end)
    tr, idle, beta = outs["tr"], outs["idle"], outs["beta"]
    mask = policy.packet_mask(aux, cfg.N, beta.shape[-1])
    if mask is not None:
        # Block policies: packets beyond the assigned block do not exist
        # physically; exclude them from the per-helper statistics.
        tr = torch.where(mask, tr, torch.inf)
        idle = torch.where(mask, idle, 0.0)
        beta = torch.where(mask, beta, 0.0)
    eff = sim.efficiency_measured(tr, idle, beta, t)
    # isfinite guard: when t is +inf (an uncompletable block-policy rep)
    # the inf sentinels in tr must not count as delivered packets.
    r_n = (torch.isfinite(tr) & (tr <= t[:, None, None])).sum(dim=-1)
    # Loss rate over packets actually sent: a policy that stops a stream
    # early must not have its never-sent tail dilute it (0 when static).
    n_sent = torch.isfinite(outs["tx"]).sum(dim=-1)
    m_steps = outs["lost"].shape[-1]
    # The mean as XLA computes it, the sum times a float32 reciprocal.
    inv_m = float(np.float32(1.0) / np.float32(m_steps))
    lost_frac = (outs["lost"].float().sum(dim=-1) * inv_m) * sim._rdiv(
        float(m_steps), torch.clamp_min(n_sent, 1).float())
    return dict(T=t, valid=valid, efficiency=eff, r_n=r_n,
                max_backoff=outs["backoff"].amax(dim=-1), lost_frac=lost_frac)


def simulate(tables: Tables, cfg, R: int, policy) -> Dict[str, torch.Tensor]:
    """Run ``policy`` over drawn tables and extract every rep's completion
    time, certification and per-helper statistics.  The policy's summary
    values come back under ``x_<name>`` keys (``RunResult.extras``)."""
    policy = _as_policy(policy)
    c = cfg.ccp_cfg(R)
    aux = policy.prepare(cfg, R, c, tables.mu, tables.a, tables.rate)
    churn = cfg.churn is not None
    if churn and tables.dyn is None:
        raise ValueError("cfg has churn but the tables carry no dynamics")
    outs, psum = policy_stream(
        tables.beta, tables.d_up, tables.d_ack, tables.d_down, policy=policy,
        cfg_static=(c.Bx, c.Br, c.Back, c.alpha),
        churn_static=cfg.churn.static_key() if churn else None,
        dyn=tables.dyn if churn else None, a=tables.a, aux=aux)
    # Under churn the last simulated Tr can be inf while the next send is
    # finite: certify on the first unsimulated send (tx_end) instead.
    res = _task_stats(outs, aux, cfg, R, policy, outs["tx_end"] if churn else None)
    res.update(mu=tables.mu, a=tables.a, rate=tables.rate)
    res.update({f"x_{k}": aux[k] for k in policy.report_aux})
    res.update({f"x_{k}": v for k, v in psum.items()})
    return res


# ---------------------------------------------------------------------------
# One fleet batch: T tenants contending for cfg.N shared helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetTables:
    """A fleet batch's random draws: the shared helper draws (B, N), each
    tenant's packet tables (B, T, N, M), releases (B, T), the recruit mask
    (B, T, N) and priority keys (B, T), and under churn the fleet dynamics
    of :func:`repro_torch.core.simulator.stack_fleet_dynamics` (None when
    static)."""

    mu: torch.Tensor
    a: torch.Tensor
    rate: torch.Tensor
    beta: torch.Tensor
    d_up: torch.Tensor
    d_ack: torch.Tensor
    d_down: torch.Tensor
    release: torch.Tensor
    recruit: torch.Tensor
    prio: torch.Tensor
    dyn: Optional[dict] = None

    def to(self, device) -> "FleetTables":
        """The same tables (and dynamics) on ``device``."""
        return _map_tables(self, lambda t: t.to(device))

    def take(self, reps: torch.Tensor) -> "FleetTables":
        """The reps ``reps`` (an index tensor on the tables' device)."""
        return _map_tables(self, lambda t: t.index_select(0, reps))


def draw_fleet_tables(gen: torch.Generator, cfg, fleet, reps: int, R: int,
                      M: int) -> FleetTables:
    """Draw a fleet batch from ``gen``: the helpers, then each tenant's
    packet tables and dynamics in turn (task 0's are exactly
    :func:`draw_tables`' from the same generator state: the equivalence
    spine), then the releases and the placement.  Tenants share the helper
    draw and its helper-state processes; per-packet draws are per tenant."""
    from . import fleet as fleet_mod

    mu, a, rate = sim.draw_helpers(gen, cfg, reps)
    tasks = [sim.draw_task_tables(gen, cfg, mu, a, rate, M, R) for _ in range(fleet.n_tasks)]
    stack = lambda j: torch.stack([t[j] for t in tasks], dim=1)  # noqa: E731
    dyn = None if cfg.churn is None else sim.stack_fleet_dynamics([t[4] for t in tasks])
    release = fleet_mod.draw_releases(gen, fleet, reps)
    recruit, prio = fleet_mod.place(gen, fleet, cfg, mu, a, rate)
    return FleetTables(mu, a, rate, stack(0), stack(1), stack(2), stack(3),
                       release, recruit, prio, dyn)


def simulate_fleet(tables: FleetTables, cfg, R: int, policy, fleet) -> Dict[str, torch.Tensor]:
    """Run ``policy`` for every tenant of a drawn fleet batch and extract,
    per (rep, task), completion, certification and per-helper statistics
    ((B, T[, N])), the sojourn (completion minus release), and per rep the
    makespan, helper utilization (B, N) and Jain fairness (B,): the
    counterpart of the reference's ``_fleet_one``."""
    from . import fleet as fleet_mod

    policy = _as_policy(policy)
    c = cfg.ccp_cfg(R)
    B, T = tables.release.shape
    churn = cfg.churn is not None
    if churn and tables.dyn is None:
        raise ValueError("cfg has churn but the tables carry no dynamics")
    per_task = policy.fleet_aux == "per_task"
    if per_task:
        # Block policies: one aux per tenant, so the fixed allocation lands
        # on the tenant's recruited helpers.
        aux = policy.prepare_fleet(cfg, R, c, tables.mu, tables.a, tables.rate, tables.recruit)
        rows = {k: v.reshape((B * T,) + v.shape[2:]) for k, v in aux.items()}
    else:
        aux = policy.prepare(cfg, R, c, tables.mu, tables.a, tables.rate)
        rows = fleet_mod.stream.task_rows(aux, T)
    outs, psum = fleet_mod.fleet_stream(
        tables.beta, tables.d_up, tables.d_ack, tables.d_down, tables.release,
        tables.recruit, tables.prio, policy=policy,
        cfg_static=(c.Bx, c.Br, c.Back, c.alpha), fleet_static=fleet.static_key(),
        churn_static=cfg.churn.static_key() if churn else None,
        dyn=tables.dyn if churn else None, a=tables.a, aux=aux, aux_task_axis=per_task)
    flat = lambda v: v.reshape((B * T,) + v.shape[2:])  # noqa: E731
    keys = ("tr", "idle", "tx", "arrive", "beta", "lost", "backoff")
    keys += ("sym_id",) if policy.uses_decoder else ()
    stats = _task_stats({k: flat(outs[k]) for k in keys}, rows, cfg, R, policy,
                        flat(outs["tx_end"]) if churn else None)
    res = {k: v.reshape((B, T) + v.shape[1:]) for k, v in stats.items()}
    res["release"] = tables.release
    res["sojourn"] = res["T"] - tables.release
    # Fleet metrics: helper utilization over the rep's makespan and Jain
    # fairness over the certified tenants' sojourns.
    vmask = res["valid"] & torch.isfinite(res["T"])
    res["makespan"] = torch.where(vmask, res["T"], -torch.inf).amax(dim=-1)
    res["util"] = fleet_mod.helper_utilization(outs["beta"], outs["tr"], tables.d_down,
                                               res["makespan"])
    res["fairness"] = fleet_mod.jain_fairness(res["sojourn"], vmask)
    res.update(mu=tables.mu, a=tables.a, rate=tables.rate)
    res.update({f"x_{k}": aux[k] for k in policy.report_aux})
    res.update({f"x_{k}": v for k, v in psum.items()})
    return res


def _m_cap(cfg, kk: int, policy) -> int:
    # Static: every helper streams back-to-back, so M = R+K always
    # certifies.  Under churn a helper's M packets can include losses;
    # block policies must cover the largest assigned block: leave headroom.
    factor = policy.m_cap_factor
    if factor is None:
        factor = 1 if cfg.churn is None else 4
    return factor * kk


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
    name; extras the policy's summary (``dec_count`` and ``dec_done`` (B,)
    for the decoder policies).
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
    extras: Dict[str, torch.Tensor]
    M: int
    policy: str

    def __getitem__(self, key):
        return self.as_dict()[key]

    def keys(self):
        return self.as_dict().keys()

    def as_dict(self) -> Dict[str, object]:
        d = {f: getattr(self, f) for f in _CORE_FIELDS}
        d.update(self.extras)
        d["M"] = self.M
        return d


_FLEET_FIELDS = ("T", "sojourn", "release", "valid", "efficiency", "r_n", "mu", "a",
                 "rate", "max_backoff", "lost_frac", "util", "fairness", "makespan")


@dataclasses.dataclass
class FleetRunResult:
    """Structured result of ``Engine.run_fleet`` over B reps of an
    ``n_tasks``-tenant fleet sharing ``cfg.N`` helpers, as tensors on the
    run's device.

    T / sojourn / release / valid: (B, n_tasks) per-task completion time
    (absolute), completion minus release, release time, and certification
    mask (an uncertified task MUST be dropped and counted, never averaged);
    efficiency / r_n / max_backoff / lost_frac: (B, n_tasks, N) per task
    and helper; mu / a / rate: (B, N) shared helper draws; util: (B, N)
    per-helper busy fraction inside the rep's makespan; fairness: (B,)
    Jain index over the certified tasks' sojourns; makespan: (B,) the last
    certified completion.  ``summary()`` reduces the batch to the values
    the ``fig_fleet`` sweep plots.
    """

    T: torch.Tensor
    sojourn: torch.Tensor
    release: torch.Tensor
    valid: torch.Tensor
    efficiency: torch.Tensor
    r_n: torch.Tensor
    mu: torch.Tensor
    a: torch.Tensor
    rate: torch.Tensor
    max_backoff: torch.Tensor
    lost_frac: torch.Tensor
    util: torch.Tensor
    fairness: torch.Tensor
    makespan: torch.Tensor
    extras: Dict[str, torch.Tensor]
    M: int
    policy: str
    n_tasks: int
    discipline: str

    def __getitem__(self, key):
        return self.as_dict()[key]

    def keys(self):
        return self.as_dict().keys()

    def as_dict(self) -> Dict[str, object]:
        d = {f: getattr(self, f) for f in _FLEET_FIELDS}
        d.update(self.extras)
        d["M"] = self.M
        return d

    def summary(self) -> Dict[str, float]:
        """Batch values of the saturation sweep: p50/p99 sojourn over the
        certified tasks, mean helper utilization and fairness, and the
        uncertified-task count (on the host, as the reference's)."""
        valid = self.valid.cpu().numpy()
        sojourn = self.sojourn.cpu().numpy()
        soj = sojourn[valid & np.isfinite(sojourn)]
        return dict(
            p50=float(np.percentile(soj, 50)) if soj.size else float("nan"),
            p99=float(np.percentile(soj, 99)) if soj.size else float("nan"),
            util_mean=float(np.nanmean(self.util.cpu().numpy())),
            fairness_mean=float(np.nanmean(self.fairness.cpu().numpy())),
            invalid=int((~valid).sum()),
        )


def _simulate_sharded(simulate_fn, tables, devices, home: torch.device) -> Dict[str, torch.Tensor]:
    """``simulate_fn`` over the reps of ``tables`` split evenly over
    ``devices``, joined in rep order on ``home``.  The batch is padded to a
    multiple of the device count by repeating its last rep (the
    reference's ``_sim_batch_sharded`` pads keys so), and the padding is
    dropped after the join.  Every output leads with the slice's reps (or
    with reps x tenants, rep-major)."""
    B = tables.mu.shape[0]
    n = len(devices)
    per = -(-B // n)
    parts = []
    for d, dev in enumerate(devices):
        reps = torch.arange(d * per, (d + 1) * per, device=tables.mu.device).clamp_max(B - 1)
        parts.append(simulate_fn(tables.take(reps).to(dev)))
    out = {}
    for k in parts[0]:
        rows = parts[0][k].shape[0]
        if rows % per:
            raise ValueError(f"output {k!r} of a {per}-rep slice has {rows} rows")
        joined = torch.cat([p[k].to(home) for p in parts])
        out[k] = joined[: B * (rows // per)]
    return out


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
    certified or the cap is hit.  ``run_fleet`` does the same for T tenants
    sharing one pool.

    With ``shard=True`` (or ``run(..., shard=True)``) the reps are split
    over ``devices`` (default: every local device of the engine's type;
    ``["cuda:0"] * 4`` runs four slices on one card), as the reference
    splits its keys over a 'data' mesh: the tables are drawn once on the
    engine's device from the same generator state as the unsharded run,
    each device simulates its slice, and the slices are joined on the
    engine's device.  Certification is decided over the joined batch, so
    every slice runs the unsharded run's horizon and the results are
    bitwise the unsharded run's.
    """

    def __init__(self, device=None, shard: bool = False, devices=None):
        self.device = _device.resolve(device)
        self.shard = bool(shard)
        self.devices = None if devices is None else [torch.device(d) for d in devices]

    def _simulator(self, simulate_fn, shard: Optional[bool], devices):
        """``simulate_fn`` itself, or its sharded run over the devices."""
        if not (self.shard if shard is None else shard):
            return simulate_fn
        devs = self.devices if devices is None else [torch.device(d) for d in devices]
        if devs is None:
            from ..parallel import sharding
            devs = (list(sharding.data_mesh().devices) if self.device.type == "cuda"
                    else [self.device])
        if not devs:
            raise ValueError("shard=True needs at least one device")
        return lambda tables: _simulate_sharded(simulate_fn, tables, devs, self.device)

    def run(self, cfg, policy, reps: int, R: int, *,
            seed: Union[int, torch.Generator] = 0,
            M_override: Optional[int] = None, shard: Optional[bool] = None,
            devices=None) -> RunResult:
        """Run ``policy`` (a registry name or Policy instance) over ``reps``
        reps drawn from ``seed`` (an int or a ``torch.Generator`` on the
        engine's device); returns a :class:`RunResult`.  ``shard`` and
        ``devices`` override the engine's own for this run."""
        policy = _as_policy(policy)
        _check_R(R)
        _check_reps(reps)
        run_tables = self._simulator(lambda t: simulate(t, cfg, R, policy), shard, devices)
        gen = _generator(seed, self.device)
        state = gen.get_state()
        kk = R + cfg.K(R)
        cap = _m_cap(cfg, kk, policy)
        M = _initial_m(sim._horizon_shared(cfg, R), cfg, R, kk, cap, policy,
                       M_override)
        for _ in range(8):
            gen.set_state(state)
            out = run_tables(draw_tables(gen, cfg, reps, R, M))
            if bool(out["valid"].all()) or M >= cap or M_override is not None:
                break
            M = min(M * 2, cap)
        extras = {k[2:]: v for k, v in out.items() if k.startswith("x_")}
        core = {k: v for k, v in out.items() if not k.startswith("x_")}
        return RunResult(M=M, policy=policy.name, extras=extras, **core)

    def run_fleet(self, cfg, policy, reps: int, R: int, *, fleet=None,
                  seed: Union[int, torch.Generator] = 0,
                  M_override: Optional[int] = None, shard: Optional[bool] = None,
                  devices=None) -> FleetRunResult:
        """Multi-tenant event-clock run: ``fleet.n_tasks`` concurrent tasks
        contend for the ``cfg.N`` shared helpers under the fleet's service
        discipline and admission rule.

        ``fleet`` is a :class:`repro_torch.core.fleet.FleetConfig` (default:
        one task, all helpers, FIFO); at one task with all helpers the run
        is ``Engine.run`` bit for bit, for every registered policy.  The
        shared horizon doubles as in :meth:`run` until every (rep, task)
        completion is certified or the cap is hit.  ``shard`` and
        ``devices`` split the reps as in :meth:`run` (every tenant of a rep
        lives on that rep's device)."""
        from . import fleet as fleet_mod

        policy = _as_policy(policy)
        fleet = fleet_mod.FleetConfig() if fleet is None else fleet
        if not isinstance(fleet, fleet_mod.FleetConfig):
            raise TypeError(
                "fleet must be a repro_torch.core.fleet.FleetConfig (or None for "
                f"the 1-task default), got {type(fleet).__name__}: {fleet!r}")
        if fleet.placement not in fleet_mod.PLACEMENTS:
            raise ValueError(
                f"unknown placement {fleet.placement!r}; known: "
                f"{sorted(fleet_mod.PLACEMENTS)} (register_placement adds custom rules)")
        if fleet.helpers_per_task is not None and fleet.helpers_per_task > cfg.N:
            raise ValueError(
                f"helpers_per_task={fleet.helpers_per_task} exceeds the "
                f"cfg.N={cfg.N} helpers in the pool")
        _check_R(R)
        _check_reps(reps)
        run_tables = self._simulator(lambda t: simulate_fleet(t, cfg, R, policy, fleet), shard,
                                     devices)
        gen = _generator(seed, self.device)
        state = gen.get_state()
        kk = R + cfg.K(R)
        cap = _m_cap(cfg, kk, policy)
        M = _initial_m(sim._horizon_shared(cfg, R), cfg, R, kk, cap, policy,
                       M_override)
        for _ in range(8):
            gen.set_state(state)
            out = run_tables(draw_fleet_tables(gen, cfg, fleet, reps, R, M))
            if bool(out["valid"].all()) or M >= cap or M_override is not None:
                break
            M = min(M * 2, cap)
        extras = {k[2:]: v for k, v in out.items() if k.startswith("x_")}
        core = {k: v for k, v in out.items() if not k.startswith("x_")}
        return FleetRunResult(M=M, policy=policy.name, n_tasks=fleet.n_tasks,
                              discipline=fleet.discipline, extras=extras, **core)

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
