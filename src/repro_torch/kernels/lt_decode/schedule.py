"""The schedule K3 walks: one int32 program per peeling plan.

``csrc/lt_decode.cu`` (K3) runs a whole plan in one launch: every thread owns
one position in every block and walks the plan's entries in round order.
This module builds what it walks, on the host, once per plan: one int32
array, copied to the card in one piece.  Records, in round order:

- round: ``[(n_pad << 2) | OP_ROUND, width, pad_0, .., pad_{n_pad-1}]``:
  the distinct blocks that the round's padding slots (zero weight) name and
  that were known before the round, whose non-finite elements turn an
  entry's element into NaN (the plain version's ``0 * inf``); ``width`` is
  the plan's neighbour slots per entry, which only the plain version reads.
- entry: ``[(nnz << 2) | OP_ENTRY, cpos, dst, padmask, inv_pivot,
  idx_0, w_0, .., idx_{nnz-1}, w_{nnz-1}]``: its nonzero-weight neighbours
  in slot order, float32 fields stored as their bits; bit q of ``padmask``
  says that a padding slot names the round's ``pad_q``.

A word 0 ends a chunk: the kernel stages the program in shared memory
``CHUNK_WORDS`` at a time, and no record straddles a chunk boundary.
``build_program`` drops entries whose ``cpos`` or ``dst`` lie outside the
buffers (a round whose entries are all dropped keeps its record) and
neighbours outside ``[0, R)``, as the kernel skips them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ...core import fountain
from .. import _nvcc

OP_ENTRY, OP_ROUND = 1, 2
CHUNK_WORDS = 2 * _nvcc.MAX_D + 8  # csrc/lt_decode.cu's MAX_CHUNK_WORDS: the largest entry fits
MAX_PADDING = 32  # padding blocks a round may list: one bit each in a thread's register


@dataclasses.dataclass(frozen=True)
class ProgramEntry:
    cpos: int
    dst: int
    padmask: int
    inv_pivot: float
    idx: np.ndarray  # (nnz,) int32 nonzero-weight neighbours, in slot order
    w: np.ndarray    # (nnz,) float32 their weights


@dataclasses.dataclass(frozen=True)
class ProgramRound:
    padding: np.ndarray  # (n_pad,) int32 padding blocks known before the round
    width: int
    entries: List[ProgramEntry]


def build_program(cpos, dst, idx, w, inv_pivot, rnd, known_round, *, R: int,
                  n_rx: int) -> np.ndarray:
    """Pack S entries into a program.  ``cpos``, ``dst``, ``inv_pivot`` and
    ``rnd`` (the round of each entry, ascending) are (S,); ``idx`` and ``w``
    (S, width) neighbour slots (weight 0 = padding); block b counts as known
    before round r when ``known_round[b] < r``.  Returns the int32 words,
    zero-padded to a multiple of 4."""
    cpos, dst, rnd = (np.asarray(v, dtype=np.int64) for v in (cpos, dst, rnd))
    idx = np.asarray(idx, dtype=np.int64)
    w = np.asarray(w, dtype=np.float32)
    inv_pivot = np.asarray(inv_pivot, dtype=np.float32)
    width = idx.shape[1]
    if (rnd[1:] < rnd[:-1]).any():
        raise ValueError("entries must come in round order")
    rounds = rnd[np.flatnonzero(np.diff(rnd, prepend=-1))]  # a record each, kept entries or not
    keep = (cpos >= 0) & (cpos < n_rx) & (dst >= 0) & (dst < R)
    if not keep.all():
        cpos, dst, rnd, idx, w, inv_pivot = (v[keep] for v in (cpos, dst, rnd, idx, w, inv_pivot))
    S = cpos.shape[0]
    in_range = (idx >= 0) & (idx < R)
    real = (w != 0) & in_range
    nnz = real.sum(axis=1)
    # Each round's padding list: the distinct (round, block) keys of padding
    # slots whose block was known before the round, in key order.
    known = np.asarray(known_round, dtype=np.int64)[np.where(in_range, idx, 0)]
    padk = (w == 0) & in_range & (known < rnd[:, None])
    keys = rnd[:, None] * R + idx
    uniq = np.unique(keys[padk])
    first = np.searchsorted(uniq, rounds * R)
    n_pad = np.searchsorted(uniq, (rounds + 1) * R) - first
    if n_pad.size and n_pad.max() > MAX_PADDING:
        raise ValueError(f"a round names {n_pad.max()} known padding blocks; the kernel "
                         f"takes at most {MAX_PADDING}")
    padmask = np.zeros(S, dtype=np.uint32)
    if uniq.size:
        ridx = np.searchsorted(rounds, rnd)  # each entry's round, as an index into `rounds`
        pos = (np.searchsorted(uniq, keys) - first[ridx][:, None]).clip(0, MAX_PADDING - 1)
        bits = np.left_shift(np.uint32(1), pos.astype(np.uint32), dtype=np.uint32)
        padmask = np.bitwise_or.reduce(np.where(padk, bits, np.uint32(0)), axis=1)

    # Record lengths in program order: each round's record, then its entries.
    n_rec = rounds.size + S
    is_round = np.zeros(n_rec, dtype=bool)
    round_rec = np.searchsorted(rnd, rounds) + np.arange(rounds.size)
    is_round[round_rec] = True
    entry_rec = np.flatnonzero(~is_round)
    lengths = np.empty(n_rec, dtype=np.int64)
    lengths[round_rec] = 2 + n_pad
    lengths[entry_rec] = 5 + 2 * nnz
    if lengths.size and lengths.max() > CHUNK_WORDS:
        raise ValueError(f"a record of {lengths.max()} words exceeds CHUNK_WORDS={CHUNK_WORDS}")
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    if lengths.sum() > CHUNK_WORDS:  # move each record that would straddle a chunk to the next
        pos_w = 0
        for i, n in enumerate(lengths.tolist()):
            if pos_w // CHUNK_WORDS != (pos_w + n - 1) // CHUNK_WORDS:
                pos_w = (pos_w // CHUNK_WORDS + 1) * CHUNK_WORDS
            starts[i] = pos_w
            pos_w += n
    total = int(starts[-1] + lengths[-1]) if n_rec else 0
    words = np.zeros((total + 3) // 4 * 4, dtype=np.int32)

    rs = starts[round_rec]
    words[rs] = (n_pad << 2) | OP_ROUND
    words[rs + 1] = width
    u_round = np.searchsorted(rounds, uniq // R)
    words[rs[u_round] + 2 + np.arange(uniq.size) - first[u_round]] = uniq % R
    es = starts[entry_rec]
    words[es] = (nnz << 2) | OP_ENTRY
    words[es + 1] = cpos
    words[es + 2] = dst
    words[es + 3] = padmask.view(np.int32)
    words[es + 4] = inv_pivot.view(np.int32)
    rows, cols = np.nonzero(real)
    k = (np.cumsum(real, axis=1) - 1)[rows, cols]
    words[es[rows] + 5 + 2 * k] = idx[rows, cols]
    words[es[rows] + 6 + 2 * k] = w[rows, cols].view(np.int32)
    return words


def plan_program(plan: fountain.DecodePlan, n_rx: int) -> np.ndarray:
    """The program of a peeling plan's peeled steps, in
    :func:`~repro_torch.core.fountain.plan_rounds` order, as the reference's
    round kernel runs them; a round's padding list holds the blocks received
    directly or recovered in earlier rounds.  Empty when the plan peels
    nothing."""
    step = fountain.plan_step_rounds(plan)
    order = np.argsort(step, kind="stable")
    known = np.full(plan.R, np.iinfo(np.int64).max, dtype=np.int64)
    known[plan.direct_src] = 0
    known[plan.order_src] = step
    return build_program(plan.order_coded[order], plan.order_src[order],
                         plan.order_nbr_idx[order], plan.order_nbr_coef[order],
                         (1.0 / plan.order_pivot[order]).astype(np.float32), step[order], known,
                         R=plan.R, n_rx=n_rx)


def scan_program(plan: fountain.DecodePlan, n_rx: int) -> np.ndarray:
    """The program of a peeling plan's peeled steps in plan order, one
    round each, as :func:`~repro_torch.core.fountain.apply_decode_plan` (the
    reference's ``lax.scan``) runs them: a step's padding list holds the
    blocks received directly or recovered by an earlier step, read as the
    previous step left them.  Empty when the plan peels nothing."""
    step = np.arange(1, plan.n_peeled + 1, dtype=np.int64)
    known = np.full(plan.R, np.iinfo(np.int64).max, dtype=np.int64)
    known[plan.direct_src] = 0
    known[plan.order_src] = step
    return build_program(plan.order_coded, plan.order_src, plan.order_nbr_idx,
                         plan.order_nbr_coef, (1.0 / plan.order_pivot).astype(np.float32),
                         step, known, R=plan.R, n_rx=n_rx)


def round_program(cpos, dst, idx, w, inv_pivot, *, R: int, n_rx: int) -> np.ndarray:
    """The program of one round: its padding list holds every block its
    padding slots name, read as src stands before the round."""
    S = np.asarray(cpos).shape[0]
    return build_program(cpos, dst, idx, w, inv_pivot, np.ones(S, dtype=np.int64),
                         np.zeros(R, dtype=np.int64), R=R, n_rx=n_rx)


def read_program(words: np.ndarray) -> List[ProgramRound]:
    """The rounds and entries of a program, in the order the kernel walks
    them (zero words are chunk padding)."""
    words = np.asarray(words, dtype=np.int32)
    rounds: List[ProgramRound] = []
    p = 0
    while p < words.size:
        head = int(words[p])
        count, op = head >> 2, head & 3
        if head == 0:
            p += 1
        elif op == OP_ROUND:
            rounds.append(ProgramRound(padding=words[p + 2:p + 2 + count].copy(),
                                       width=int(words[p + 1]), entries=[]))
            p += 2 + count
        elif op == OP_ENTRY and rounds:
            nb = words[p + 5:p + 5 + 2 * count]
            rounds[-1].entries.append(ProgramEntry(
                cpos=int(words[p + 1]), dst=int(words[p + 2]),
                padmask=int(np.uint32(words[p + 3].view(np.uint32))),
                inv_pivot=float(words[p + 4:p + 5].view(np.float32)[0]),
                idx=nb[0::2].copy(), w=nb[1::2].view(np.float32).copy()))
            p += 5 + 2 * count
        else:
            raise ValueError(f"word {p} ({head}) is not a record of a program")
    return rounds


def program_costs(words: np.ndarray, L: int, elem: int) -> Tuple[float, int]:
    """(operations, bytes) of one launch of a program over blocks of ``L``
    elements of ``elem`` bytes, the counts of K3's bound: a multiply-add per
    element of each nonzero-weight neighbour and a scale per recovered
    element; the inputs read once (each entry's coded block, and the source
    blocks its neighbours and padding lists name that the program does not
    recover itself) and each recovered block written once, plus the
    program's words.  A block the launch recovers and reads again is an
    intermediate."""
    rounds = read_program(words)
    entries = [e for r in rounds for e in r.entries]
    named = {int(b) for r in rounds for b in r.padding}
    named |= {int(b) for e in entries for b in e.idx}
    dsts = {e.dst for e in entries}
    inputs = len({e.cpos for e in entries}) + len(named - dsts)
    n_nbr = sum(int(e.idx.size) for e in entries)
    ops = 2.0 * n_nbr * L + len(entries) * L
    return ops, (inputs + len(entries)) * L * elem + int(np.asarray(words).size) * 4
