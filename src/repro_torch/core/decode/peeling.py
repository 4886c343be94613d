"""Incremental LT peeling decoder, batched over Monte-Carlo reps.

The offline decoder (:func:`repro_torch.core.fountain.peel_decode_plan`)
walks the residual graph with Python sets: exact, but host-side and one
received set at a time.  This module is the *online* mirror: fixed-shape
tensors with a leading rep dimension ``B``, so the decode state rides the
engine's per-packet loop for every rep at once.

Port of ``repro.core.decode.peeling``.  The host-side numpy parts
(``_cover_order``, ``make_decoder_code``, ``offline_overhead_samples``) are
copied as they are; the rest replaces the reference's ``vmap`` with the rep
dimension and its ``lax.while_loop`` with a host loop that runs "while any
rep still has a received row at residual degree 1".  A rep already at its
fixpoint is unchanged by a round that other reps still need (it releases
nothing), so the batched loop gives every rep the reference's result.  Each
test of the loop condition is one device-to-host copy; they are counted in
:data:`host_syncs`.

Representation
--------------
The code is the systematic LT construction of :func:`fountain.make_lt_code`
with a *parity pool* of ``P`` rows (`make_decoder_code`).  Ids ``g < R``
are the source blocks themselves and ids ``g >= R`` map onto pool row
``(g - R) % P`` (wrapping past the pool resends an earlier parity; the
absorb is idempotent, so duplicates are harmless and useless, like a
repeated fountain symbol).  Symbol ids follow the master's send counter
(:func:`send_order_ids`; the in-loop state uses the per-round approximation
``engine._send_time_ids``).  The round-robin assignment ``g = i*N + n``
(`slot_ids`) is the ``ids=None`` fallback of :func:`decode_completion`.

Decoder state (a dict of tensors, batched over reps):

==============  ===========  ================================================
``recovered``   (B, R) bool  per-source-block recovered mask
``rx``          (B, P) bool  which parity-pool rows have arrived
``res_deg``     (B, P) i32   residual degree of every pool row = #unrecovered
                             neighbours (kept for all rows, received or not,
                             so a newly arrived row is peelable at once)
``count``       (B,) i32     ``recovered.sum()``
``ripple``      (B,) i32     sources released by peeling in the last absorb
``done``        (B,) bool    ``count == R``
==============  ===========  ================================================
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ... import _device
from .. import fountain

__all__ = [
    "DEC_DMAX",
    "DEC_SEED",
    "DecoderTables",
    "absorb",
    "decode_completion",
    "decoder_aux",
    "finalize_decode",
    "init_state",
    "make_decoder_code",
    "make_tables",
    "send_order_ids",
    "offline_overhead_samples",
    "peel",
    "peel_round",
    "slot_ids",
]

#: Neighbour-slot cap for the in-loop tables (the reference's): robust-soliton
#: degrees are overwhelmingly small and :func:`fountain.make_lt_code` trims
#: the rare heavy rows coverage-aware.
DEC_DMAX = 16

#: Pool-construction seed.  The code is shared across Monte-Carlo reps, like
#: a real deployment's task-id-seeded pseudo-random code.
DEC_SEED = 0xDEC0DE

DecoderTables = dict  # {"idx": (P, d_max) int64, "mask": (P, d_max) bool}

#: Device-to-host copies made by the decoder's loop conditions (each test of
#: "does any rep still peel?").  Callers reset it to 0 before a run they
#: want to count.
host_syncs = 0


def _any_on_host(t: torch.Tensor) -> bool:
    global host_syncs
    host_syncs += 1
    return bool(t.any())


def _cover_order(idx: np.ndarray, mask: np.ndarray, R: int) -> np.ndarray:
    """Permutation of the parity rows into successive greedy covers.

    The rateless stream emits pool rows in order, so the rows a decoder sees
    *first* matter most.  Re-ordering the pool as cover after cover (each
    pass sweeps the remaining rows, keeping those that touch a source the
    pass has not covered yet) guarantees every source is touched within
    ~``R/E[deg]`` emitted parities per pass, while the *set* of pool rows
    (and hence the code) is unchanged.
    """
    P = idx.shape[0]
    sets = [idx[p, mask[p]] for p in range(P)]
    remaining = list(range(P))
    order: list = []
    while remaining:
        covered = np.zeros(R, bool)
        deferred = []
        for p in remaining:
            if not covered.all() and not covered[sets[p]].all():
                covered[sets[p]] = True
                order.append(p)
            else:
                deferred.append(p)
        if len(deferred) == len(remaining):  # no progress possible
            order.extend(deferred)
            break
        remaining = deferred
    return np.asarray(order, dtype=np.int64)


@functools.lru_cache(maxsize=64)
def make_decoder_code(R: int, K_pool: Optional[int] = None, *,
                      seed: int = DEC_SEED,
                      d_max: int = DEC_DMAX) -> fountain.LTCode:
    """Systematic LT code with a parity pool sized for in-loop decoding.

    ``K_pool`` defaults to ``max(R, 64)``.  The pool rows are permuted into
    successive greedy covers (:func:`_cover_order`).  Memoized: callers must
    treat the returned (numpy-backed) code as immutable.
    """
    if K_pool is None:
        K_pool = max(R, 64)
    code = fountain.make_lt_code(R, K_pool, seed=seed, d_max=d_max)
    perm = _cover_order(code.idx[R:], code.mask[R:], R)
    sl = np.concatenate([np.arange(R), R + perm])
    return fountain.LTCode(idx=code.idx[sl], mask=code.mask[sl],
                           coef=code.coef[sl], R=R, K=code.K)


def make_tables(code: fountain.LTCode, device=None) -> DecoderTables:
    """Parity-pool neighbour tables on ``device`` (the systematic prefix is
    implicit).  Indices are int64, the type torch indexes with."""
    dev = _device.resolve(device)
    return {
        "idx": torch.as_tensor(code.idx[code.R:], dtype=torch.int64, device=dev),
        "mask": torch.as_tensor(code.mask[code.R:], dtype=torch.bool, device=dev),
    }


def decoder_aux(R: int, batch: int, device=None, **code_kw) -> dict:
    """The ``aux["decoder"]`` dict a ``uses_decoder`` policy's ``prepare``
    hands the engine: pool tables (sent to the device once per run) and the
    zero state of ``batch`` reps."""
    tables = make_tables(make_decoder_code(R, **code_kw), device)
    return {"tables": tables, "state0": init_state(R, tables, batch)}


def init_state(R: int, tables: DecoderTables, batch: int) -> dict:
    deg = tables["mask"].sum(dim=1).to(torch.int32)
    P, dev = tables["idx"].shape[0], deg.device
    return dict(
        recovered=torch.zeros((batch, R), dtype=torch.bool, device=dev),
        rx=torch.zeros((batch, P), dtype=torch.bool, device=dev),
        res_deg=deg.expand(batch, P).clone(),
        count=torch.zeros((batch,), dtype=torch.int32, device=dev),
        ripple=torch.zeros((batch,), dtype=torch.int32, device=dev),
        done=torch.zeros((batch,), dtype=torch.bool, device=dev),
    )


def slot_ids(i: int, n: int, device=None) -> torch.Tensor:
    """Global coded id of each helper's packet at step ``i``: fresh symbols
    handed out round-robin across helpers."""
    return i * n + torch.arange(n, dtype=torch.int32, device=_device.resolve(device))


def _scatter_any(vals: torch.Tensor, index: torch.Tensor, size: int) -> torch.Tensor:
    """``out[b, index[b, i]] |= vals[b, i]`` into a (B, size) bool tensor of
    zeros: the reference's ``zeros.at[index].max(vals)``.  Torch has no
    bool scatter-max, so it counts in int32; duplicate indices stay
    idempotent."""
    B = vals.shape[0]
    out = torch.zeros((B, size), dtype=torch.int32, device=vals.device)
    out.scatter_add_(1, index.expand(B, -1), vals.to(torch.int32))
    return out > 0


def _neighbours(x: torch.Tensor, tables: DecoderTables) -> torch.Tensor:
    """``x[:, tables["idx"]]``, (B, P, d_max), as one gather: on the CPU
    advanced indexing runs a multithreaded kernel that is ~100x slower than
    a gather when other processes load the cores."""
    idx = tables["idx"]
    flat = idx.reshape(1, -1).expand(x.shape[0], -1)
    return torch.gather(x, 1, flat).view(x.shape[0], *idx.shape)


def _deg_drop(tables: DecoderTables, new_src: torch.Tensor) -> torch.Tensor:
    """Per-pool-row count of neighbours newly recovered (``new_src`` (B, R))."""
    return (tables["mask"] & _neighbours(new_src, tables)).sum(dim=-1).to(torch.int32)


def peel_round(recovered, res_deg, rx, tables):
    """One peel round: every received row of residual degree 1 releases its
    unique unrecovered neighbour.  Returns (recovered, res_deg, released)."""
    rel = rx & (res_deg == 1)
    cand = tables["mask"] & ~_neighbours(recovered, tables)  # (B, P, d_max)
    new_src = _scatter_any((cand & rel[..., None]).flatten(1),
                           tables["idx"].reshape(1, -1), recovered.shape[1])
    recovered = recovered | new_src
    res_deg = res_deg - _deg_drop(tables, new_src)
    return recovered, res_deg, new_src.sum(dim=-1).to(torch.int32)


def peel(state: dict, tables: DecoderTables) -> dict:
    """Peel every rep to its fixpoint (no received row left at residual
    degree 1)."""
    rx, recovered, res_deg = state["rx"], state["recovered"], state["res_deg"]
    released = torch.zeros_like(state["count"])
    while _any_on_host(rx & (res_deg == 1)):
        recovered, res_deg, n = peel_round(recovered, res_deg, rx, tables)
        released = released + n
    count = recovered.sum(dim=-1).to(torch.int32)
    return dict(state, recovered=recovered, res_deg=res_deg, count=count,
                ripple=released, done=count == recovered.shape[1])


def absorb(state: dict, tables: DecoderTables, ids, received) -> dict:
    """Fold a batch of arrivals (global ids ``ids`` (B, n) or (n,), arrival
    mask ``received`` of the same shape) into the state and peel to the
    fixpoint.

    Idempotent per id: duplicate systematic copies and pool-wrapped parity
    resends are no-ops, so callers never need to dedupe."""
    B, R = state["recovered"].shape
    P = tables["idx"].shape[0]
    ids = ids.to(torch.int64).expand(B, -1)
    received = received.expand(B, -1)
    is_sys = ids < R
    rec0 = state["recovered"]
    recovered = rec0 | _scatter_any(received & is_sys, ids.clamp(0, R - 1), R)
    new_src = recovered & ~rec0
    pid = torch.remainder(ids - R, P).clamp(0, P - 1)  # Python's mod, as jnp.mod
    rx = state["rx"] | _scatter_any(received & ~is_sys, pid, P)
    res_deg = state["res_deg"] - _deg_drop(tables, new_src)
    return peel(dict(state, recovered=recovered, rx=rx, res_deg=res_deg), tables)


# ---------------------------------------------------------------------------
# Time-exact decode completion (the honest replacement for the packet count)
# ---------------------------------------------------------------------------

def _closure_success(rec0, rx, tables, deg) -> torch.Tensor:
    """Peel from-scratch received sets (B reps) to their fixpoints; True
    where the rep decodes."""
    recovered, res_deg = rec0, deg - _deg_drop(tables, rec0)
    while _any_on_host((rx & (res_deg == 1)).any(dim=-1) & ~recovered.all(dim=-1)):
        recovered, res_deg, _ = peel_round(recovered, res_deg, rx, tables)
    return recovered.all(dim=-1)


def decode_completion(
    tr: torch.Tensor,
    tables: DecoderTables,
    R: int,
    tx_end: Optional[torch.Tensor] = None,
    ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact decode-success completion time from the (B, N, M) arrival table.

    Sorts every rep's result arrivals by time and binary-searches the
    shortest prefix whose coded-id set peels to a full decode (success is
    monotone in the prefix, so the search is exact).  Returns ``(T, valid,
    k_star)``, each (B,): ``k_star - R`` is the measured LT overhead;
    ``valid`` applies the horizon certification of
    :func:`repro_torch.core.simulator.completion_time` and is False when
    even the full horizon's arrivals cannot decode.

    ``ids`` is the (B, N, M) global coded id each slot carried; ``None``
    gives the round-robin assignment ``g = i*N + n``.  The time sort is
    stable, as ``jnp.argsort`` is: ties keep slot order.
    """
    B, N, M = tr.shape
    dev = tr.device
    P = tables["idx"].shape[0]
    nm = N * M
    deg = tables["mask"].sum(dim=1).to(torch.int32)
    if ids is None:
        ids = (torch.arange(M, device=dev)[None, :] * N
               + torch.arange(N, device=dev)[:, None]).expand(B, N, M)
    flat_tr = tr.reshape(B, nm)
    order = torch.argsort(flat_tr, dim=-1, stable=True)
    st_tr = torch.gather(flat_tr, 1, order)
    st_ids = torch.gather(ids.reshape(B, nm).to(torch.int64), 1, order)
    n_fin = torch.isfinite(flat_tr).sum(dim=-1)
    is_sys = st_ids < R
    sid = st_ids.clamp(0, R - 1)
    pid = torch.remainder(st_ids - R, P).clamp(0, P - 1)
    pos = torch.arange(nm, device=dev)

    def success(k):
        take = pos[None, :] < k[:, None]
        rec0 = _scatter_any(take & is_sys, sid, R)
        rx = _scatter_any(take & ~is_sys, pid, P)
        return _closure_success(rec0, rx, tables, deg)

    ok_all = success(n_fin)
    iters = int(math.ceil(math.log2(max(nm, 2)))) + 2
    lo = torch.full((B,), min(R, nm), dtype=torch.int64, device=dev)  # < R never decodes
    hi = n_fin
    for _ in range(iters):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        s = success(mid)
        lo, hi = torch.where(s, lo, mid + 1), torch.where(s, mid, hi)
    k_star = hi
    last = torch.gather(st_tr, 1, (k_star - 1).clamp(0, nm - 1)[:, None])[:, 0]
    t = torch.where(ok_all, last, torch.inf)
    if tx_end is not None:
        valid = ok_all & torch.isfinite(t) & (t <= tx_end.amin(dim=-1))
    else:
        valid = ok_all & (t <= tr[:, :, -1].amin(dim=-1))
    return t, valid, k_star.to(torch.int32)


def send_order_ids(tx: torch.Tensor) -> torch.Tensor:
    """Exact send-order symbol ids of a (B, N, M) send-time trace: the rank
    of each send instant over the whole trace.

    Ties rank round-major (round, then helper index) by a stable sort, so a
    homogeneous lockstep trace reproduces the round-robin grid
    ``g = i*N + n`` bit for bit.  Unsent slots (tx = +inf) rank after every
    real send and their ids are never absorbed (their ``tr`` is +inf too)."""
    B, n, m = tx.shape
    flat = torch.where(torch.isfinite(tx), tx, torch.inf).transpose(1, 2).reshape(B, m * n)
    order = torch.argsort(flat, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1)
    return rank.reshape(B, m, n).transpose(1, 2).to(torch.int32)


def finalize_decode(outs: dict, aux: dict, R: int, tx_end) -> Tuple:
    """The shared ``Policy.finalize`` body of the decoder-in-the-loop
    policies: time-exact decode-success completion from the stream trace,
    with the master's send counter (:func:`send_order_ids` over the
    recorded ``tx`` trace) as the symbol ids."""
    ids = send_order_ids(outs["tx"]) if "tx" in outs else None
    t, valid, _k_star = decode_completion(
        outs["tr"], aux["decoder"]["tables"], R, tx_end=tx_end, ids=ids)
    return t, valid


def offline_overhead_samples(
    R: int,
    code: fountain.LTCode,
    p_loss: float,
    trials: int = 32,
    seed: int = 0,
) -> np.ndarray:
    """Offline Monte-Carlo of the arrivals-to-decode overhead (host-side).

    Coded ids go out in slot order, each is erased i.i.d. with ``p_loss``,
    and the survivors are absorbed in order until the peeling closure
    covers all R sources.  Returns the per-trial ``k_star - R`` samples
    (``-1`` when the whole pool cannot decode).
    """
    rng = np.random.default_rng(seed)
    n_rows = code.n_coded
    out = np.empty(trials, dtype=np.int64)
    for t in range(trials):
        kept = np.flatnonzero(rng.random(n_rows) >= p_loss)
        lo, hi, ans = R, kept.size, -1
        if kept.size >= R and fountain.peel_decode_plan(code, kept) is not None:
            while lo <= hi:
                mid = (lo + hi) // 2
                if fountain.peel_decode_plan(code, kept[:mid]) is not None:
                    ans, hi = mid, mid - 1
                else:
                    lo = mid + 1
        out[t] = ans - R if ans >= 0 else -1
    return out
