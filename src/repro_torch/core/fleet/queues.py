"""Per-helper service disciplines for one event-clock round.

The fleet loop hands each helper the round's batch of tenant jobs (an
arrival time, a service demand, an active mask) and the helper's carried
busy time; the discipline serializes them:

``fifo`` / ``priority``
    Non-preemptive and work-conserving, one greedy selection per job:
    whenever the server frees at time ``t`` it serves the pending (arrived,
    unserved) job with the smallest order key (the arrival time for FIFO,
    the per-task priority for ``priority``; ties to the lowest task index)
    and, if nothing has arrived yet, idles until the earliest pending
    arrival.  A served job runs from ``max(arrive, t)`` for its demand.

``ps``
    Egalitarian processor sharing, event-exact: between consecutive events
    (a job entering at ``max(arrive, busy)``, or the job with the least
    remaining work finishing) the ``n`` jobs in the system each progress at
    rate ``1/n``.  At most T entries and T completions happen, so ``2T + 1``
    iterations reach the fixpoint; converged iterations change nothing.

Work conservation: for every discipline ``busy_end - busy == sum(demand of
active jobs) + sum(idle)``.  With one job each discipline is the dedicated
helper's recurrence ``start = max(arrive, busy)``, bit for bit.

Port of ``repro.core.fleet.queues``: the tenant axis is ``dim=-2`` of
(..., T, N) job tensors, ``busy`` is (..., N), and the reference's
``lax.scan``/``fori_loop`` over T are Python loops of batched ops.
"""

from __future__ import annotations

import torch

__all__ = ["DISCIPLINES", "serve_round"]

DISCIPLINES = ("fifo", "priority", "ps")


def _greedy_serve(arrive, demand, active, busy, order_key):
    """Non-preemptive work-conserving service of one round's jobs (module
    doc).  Returns ``(start, finish, idle, busy_end)``; inactive jobs keep
    zeros and do not advance the clock."""
    T = arrive.shape[-2]
    task = torch.arange(T, device=arrive.device)[:, None]
    zero = torch.zeros((), dtype=arrive.dtype)
    start = torch.zeros_like(arrive)
    fin = torch.zeros_like(arrive)
    idle = torch.zeros_like(arrive)
    t, unserved = busy, active
    for _ in range(T):
        cand = unserved & active
        serve = cand.any(dim=-2)
        arrived = cand & (arrive <= t[..., None, :])
        pick = torch.where(arrived.any(dim=-2, keepdim=True),
                           torch.where(arrived, order_key, torch.inf),
                           torch.where(cand, arrive, torch.inf))
        j = torch.argmin(pick, dim=-2, keepdim=True)  # ties -> lowest task index
        a_j = torch.gather(arrive, -2, j)[..., 0, :]
        st = torch.maximum(a_j, t)
        fi = st + torch.gather(demand, -2, j)[..., 0, :]
        gap = torch.maximum(a_j - t, zero)
        hit = (task == j) & serve[..., None, :]
        start = torch.where(hit, st[..., None, :], start)
        fin = torch.where(hit, fi[..., None, :], fin)
        idle = torch.where(hit, gap[..., None, :], idle)
        unserved = unserved & ~hit
        t = torch.where(serve, fi, t)
    return start, fin, idle, t


def _ps_serve(arrive, demand, active, busy, order_key):
    """Event-exact egalitarian processor sharing (module doc).  A job's
    ``start`` is its entry instant ``max(arrive, busy)``; its ``finish``
    stretches with the number of concurrent jobs.  ``order_key`` is unused.
    Demands must be positive (the engine's runtimes are ``a + eps/mu``)."""
    del order_key
    T = arrive.shape[-2]
    zero = torch.zeros((), dtype=arrive.dtype)
    b = busy[..., None, :]
    entry = torch.where(active, torch.maximum(arrive, b), torch.inf)
    t = busy
    rem = torch.where(active, demand, 0.0)
    start = torch.where(active & (entry <= b), entry, 0.0)
    fin = torch.zeros_like(arrive)
    idle = torch.zeros_like(arrive)
    for _ in range(2 * T + 1):
        tt = t[..., None, :]
        in_sys = active & (entry <= tt) & (rem > 0.0)
        n = in_sys.sum(dim=-2).to(rem.dtype)
        pending = active & (entry > tt) & (rem > 0.0)
        t_entry = torch.where(pending, entry, torch.inf).amin(dim=-2)
        m = torch.where(in_sys, rem, torch.inf).amin(dim=-2)
        t_comp = torch.where(n > 0, torch.addcmul(t, m, n), torch.inf)
        te = torch.minimum(t_entry, t_comp)
        go = torch.isfinite(te)
        # Service over [t, te): at a completion event the share is exactly
        # m, so the least-remaining job reaches zero with no epsilon.
        share = torch.where(t_comp <= t_entry, m, (te - t) / torch.clamp_min(n, 1.0))
        rem2 = torch.where(in_sys, torch.maximum(rem - share[..., None, :], zero), rem)
        fin2 = torch.where(in_sys & (rem2 <= 0.0), te[..., None, :], fin)
        entering = pending & (entry <= te[..., None, :])
        # An empty server idles from t to te: the gap goes to the jobs that
        # end it, split evenly, so per-helper idle sums stay exact.
        gap = torch.where(n > 0, 0.0, te - t)
        k_in = torch.clamp_min(entering.sum(dim=-2).to(gap.dtype), 1.0)
        idle2 = torch.where(entering, idle + (gap / k_in)[..., None, :], idle)
        start2 = torch.where(entering, entry, start)
        g = go[..., None, :]
        t = torch.where(go, te, t)
        rem = torch.where(g, rem2, rem)
        start = torch.where(g, start2, start)
        fin = torch.where(g, fin2, fin)
        idle = torch.where(g, idle2, idle)
    return start, fin, idle, t


def serve_round(arrive, demand, active, busy, order_key, discipline: str):
    """Serialize one round's jobs on every helper under ``discipline``.

    arrive / demand / active / order_key: (..., T, N) per-(task, helper) job
    attributes (inactive jobs are ignored); busy: (..., N) per-helper free
    time.  Returns ``(start, finish, idle, busy_end)``: start / finish /
    idle (..., T, N), zeros for inactive jobs, and busy_end (..., N).
    """
    if discipline not in DISCIPLINES:
        raise ValueError(f"unknown discipline {discipline!r}; known: {DISCIPLINES}")
    fn = _ps_serve if discipline == "ps" else _greedy_serve
    return fn(arrive, demand, active, busy, order_key)
