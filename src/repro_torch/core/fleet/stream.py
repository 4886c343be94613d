"""The event-clock fleet loop: one shared helper pool, many tenants.

``fleet_stream`` generalizes :func:`repro_torch.core.engine.policy_stream`
from "one task, N dedicated helpers" to T tasks contending for the same N
helpers.  A step is one *round* of the virtual clock: every task offers the
current packet of each of its (task, helper) streams, the round's arrivals
at each helper are serialized by the service discipline against the
helper's carried busy time (:func:`repro_torch.core.fleet.queues.
serve_round`), and the policy hooks then run per task on the step kernels
of the single-task loop (``engine._churn_step``, ``_ge_step``,
``_transport_step``, ``_decode_step``, ``_hook_step``): so a 1-task fleet
is the single-task engine bit for bit.

Causality: rounds serialize through the per-helper busy-time carry, so
ordering across rounds is causal; two jobs *within* one round are ordered
by the discipline alone.  Under CCP-style pacing (one outstanding packet
per stream) the error is bounded by one in-flight packet per tenant.

Churn under contention: the helper-state lookups (outage, slowdown, GE
loss) are evaluated at ``t_sta0 = max(arrive, busy)``, the start the job
would see on a dedicated helper, before same-round peers serialize (a
job's queue position depends on which peers were lost).  At T=1 that is
the single-task start.

Admission uses the stopped-stream sentinel: a stream that is not
recruited starts at tx = +inf and every registered policy keeps it there.
The decoder-in-the-loop path runs one peeling decoder per tenant (tenants
share helpers, not symbols).

Port of ``repro.core.fleet.stream``.  The reference's ``vmap`` over
tenants becomes (B, T, N) physics and, for the hooks and the decoder,
(B*T, N) rows, rep-major (row ``b*T + t``), so policies run unchanged.
"""

from __future__ import annotations

import torch

from .. import ccp as ccp_mod
from .. import engine
from .. import policies as policies_mod
from . import queues

__all__ = ["fleet_stream", "task_rows"]


def task_rows(aux: dict, T: int) -> dict:
    """A per-rep ``prepare`` aux spread over the fleet's (B*T) tenant rows:
    every (B, ...) tensor repeated per tenant; the decoder's pool tables
    stay shared, its zero state is repeated."""
    rows = {}
    for k, v in aux.items():
        if k == "decoder":
            rows[k] = dict(v, state0={s: x.repeat_interleave(T, dim=0)
                                      for s, x in v["state0"].items()})
        else:
            rows[k] = v.repeat_interleave(T, dim=0)
    return rows


def fleet_stream(beta, d_up, d_ack, d_down, release, recruit, prio, policy,
                 cfg_static, fleet_static, churn_static=None, dyn=None, a=None,
                 aux=None, aux_task_axis=False):
    """Simulate M rounds of T tenant streams over N shared helpers.

    beta / d_up / d_ack / d_down: (B, T, N, M) per-tenant packet tables;
    release (B, T) task release times; recruit (B, T, N) bool admission
    mask; prio (B, T) priority keys (smaller first under 'priority').
    ``fleet_static`` is the discipline (``FleetConfig.static_key()``);
    cfg_static / churn_static / a as in
    :func:`~repro_torch.core.engine.policy_stream`; ``dyn`` from
    :func:`~repro_torch.core.simulator.stack_fleet_dynamics` (shared
    helper-state tables, per-tenant (B, T, N, M) per-packet draws).  ``aux``
    is ``policy.prepare()``'s per-rep aux, or with ``aux_task_axis=True``
    ``policy.prepare_fleet()``'s, whose tensors are (B, T, ...).

    Returns ``(outs, psummary)``: outs holds (B, T, N, M) traces (tr, idle,
    tx, arrive, beta, lost, backoff, queue_delay, and ``sym_id`` for a
    decoder policy), the (B, N, M) per-round ``contention`` counts,
    ``tx_end`` (B, T, N) and ``busy_end`` (B, N); psummary is the policy's
    summary on (B, T, ...) tensors.
    """
    Bx, Br, Back, alpha = cfg_static
    cfg = ccp_mod.CCPConfig(Bx=Bx, Br=Br, Back=Back, alpha=alpha)
    B, T, N, M = beta.shape
    BT = B * T
    dev = beta.device
    discipline = fleet_static
    churn = churn_static is not None
    ge_on = rtt_on = False
    ge_bad = ge_par = None
    max_backoff = None
    use_dec = bool(policy.uses_decoder)
    if use_dec and aux_task_axis:
        raise NotImplementedError(
            "fleet_aux='per_task' is incompatible with uses_decoder: the "
            "decoder tables and state0 under aux must be shared")
    flat = lambda v: v.reshape((BT,) + v.shape[2:])  # noqa: E731  (B, T, ...) -> rows
    aux = {} if aux is None else aux
    aux = ({k: flat(v) for k, v in aux.items()} if aux_task_axis else task_rows(aux, T))
    if churn:
        (period, max_backoff, outage_dist, ge_on,
         cell_on, rtt_dist) = engine._parse_churn_static(churn_static)
        window = period * dyn["speed"].shape[-1]
        rtt_on = rtt_dist != "off"
        # The helper-state tables per tenant row, for the churn lookups.
        dyn_rows = {k: v.repeat_interleave(T, dim=0) for k, v in dyn.items()
                    if k in ("up", "speed", "out_start", "out_end", "cell_start",
                             "cell_end", "cell_mask")}
        a_rows = a.repeat_interleave(T, dim=0)
        drop = flat(dyn["drop"])
        if ge_on:
            ge_bad, ge_par = dyn["ge_bad0"], engine._ge_params(dyn["ge_params"])

    # A stream exists iff recruited; the others never send (tx = +inf).
    tx = torch.where(recruit, release[..., None], torch.inf)
    busy = torch.zeros((B, N), device=dev)
    tr_prev = torch.zeros((BT, N), device=dev)
    pstate = policy.init((BT, N), dev)
    lost = torch.zeros((B, T, N), dtype=torch.bool, device=dev)
    ones = torch.ones((BT, N), device=dev)
    keys = ("tr", "idle", "tx", "arrive", "beta", "lost", "backoff", "queue_delay",
            "contention")
    outs = {k: [] for k in keys}
    if use_dec:
        tables = aux["decoder"]["tables"]
        dec = aux["decoder"]["state0"]
        t_hi = torch.zeros((BT,), device=dev)
        t_done = torch.full((BT,), torch.inf, device=dev)
        sym_next = torch.zeros((BT,), dtype=torch.int32, device=dev)
        outs["sym_id"] = []
    if discipline == "priority":
        order_prio = prio[..., None].expand(B, T, N)

    for i in range(M):
        beta_i, up, dn, ack = beta[..., i], d_up[..., i], d_down[..., i], d_ack[..., i]
        sent = torch.isfinite(tx)
        arrive = tx + up
        # The dedicated-helper start: churn and GE state are evaluated here,
        # before same-round peers serialize; at T=1 this is the single start.
        t_sta0 = torch.maximum(arrive, busy[:, None])
        ge_now = ge_bad
        if churn:
            t_arr = torch.where(sent, arrive, 0.0)
            t_sta = torch.where(sent, t_sta0, 0.0)
            beta_r, lost_r = engine._churn_step(
                dyn_rows, a_rows, flat(beta_i), drop[..., i], flat(t_arr), flat(t_sta),
                flat(sent), period=period, window=window, outage_dist=outage_dist,
                cell_on=cell_on)
            beta_i, lost = beta_r.reshape(B, T, N), lost_r.reshape(B, T, N)
            if ge_on:
                lost_ge, ge_bad = engine._ge_step(ge_bad, ge_par, dyn["ge_u_trans"][..., i],
                                                  dyn["ge_u_loss"][..., i], sent)
                lost = lost | lost_ge
        received = ~lost & sent

        # Shared-helper serialization: this round's tenants queue.
        demand = torch.where(received, beta_i, 0.0)
        order_key = order_prio if discipline == "priority" else arrive
        start_q, fin_q, idle, busy = queues.serve_round(
            arrive, demand, received, busy, order_key, discipline)
        start = torch.where(received, start_q, t_sta0)
        # A lost packet never occupies the helper; its hypothetical return
        # (for the policy's timeout arithmetic) assumes the dedicated start.
        tr_ok = torch.where(received, fin_q, t_sta0 + beta_i) + dn
        tr = torch.where(received, tr_ok, torch.inf)
        queue_delay = torch.where(received, start_q - t_sta0, 0.0)
        contention = received.sum(dim=1, dtype=torch.int32)
        rtt_ack = up + ack
        if rtt_on:
            # The transport delay line, as in the single-task loop: (B, T, N)
            # jitter and ACK draws against the shared base RTT and GE state.
            delay = engine._transport_step(dyn, i, ge_now, ge_par)
            tr_obs, rtt_obs = tr_ok + delay, rtt_ack + delay
        else:
            tr_obs, rtt_obs = tr_ok, rtt_ack
        tr_obs_r, sent_r, received_r = flat(tr_obs), flat(sent), flat(received)
        dec_kw = {}
        if use_dec:
            ids, sym_next = engine._send_time_ids(sym_next, flat(tx), sent_r)
            dec, t_hi, t_done = engine._decode_step(dec, t_hi, t_done, tables, ids,
                                                    received_r, tr_obs_r)
            dec_kw = dict(decoded_count=dec["count"], ripple=dec["ripple"],
                          decode_done=dec["done"], decode_t_done=t_done)
            outs["sym_id"].append(ids.reshape(B, T, N))
        ctx = policies_mod.StepCtx(
            i=i, n=N, tx=flat(tx), arrive=flat(arrive), start=flat(start),
            beta=flat(beta_i), tr_ok=tr_obs_r, lost=flat(lost), received=received_r,
            rtt_ack=flat(rtt_obs), d_up=flat(up), d_down=flat(dn), d_ack=flat(ack),
            tr_prev=tr_prev, cfg=cfg, aux=aux, max_backoff=max_backoff,
            queue_delay=flat(queue_delay),
            contention=contention.repeat_interleave(T, dim=0), **dec_kw)
        pstate, tx_next, b = engine._hook_step(policy, pstate, ctx, churn)
        for k, v in (("tr", tr), ("idle", idle), ("tx", tx), ("arrive", arrive),
                     ("beta", torch.where(sent, beta_i, 0.0)), ("lost", lost),
                     ("backoff", (ones if b is None else b).reshape(B, T, N)),
                     ("queue_delay", queue_delay), ("contention", contention)):
            outs[k].append(v)
        tr_prev = torch.where(received_r, tr_obs_r, tr_prev)
        tx = tx_next.reshape(B, T, N)

    res = {k: torch.stack(v, dim=-1) for k, v in outs.items()}
    res["tx_end"] = tx
    res["busy_end"] = busy
    psum = {k: v.reshape((B, T) + v.shape[1:]) for k, v in policy.summary(pstate).items()}
    if use_dec:
        psum.update(dec_count=dec["count"].reshape(B, T), dec_done=dec["done"].reshape(B, T))
    return res, psum
