"""Rateless (LT / fountain) coding over row-blocks.

The paper packetizes rows of ``A`` and codes them with Fountain codes
(LT/Raptor) so that *any* ``R`` of the ``R+K`` coded packets complete the
task.  On TPU a "packet" becomes an MXU-aligned *row-block* and GF(2) XOR
becomes real-valued addition (coefficients are +1), which preserves the
peeling decoder exactly (subtraction replaces XOR-cancellation).

We use a *systematic* construction: coded packets ``0..R-1`` are the source
blocks themselves (degree-1), packets ``R..R+K-1`` are parity blocks whose
degrees follow the robust-soliton distribution.  Systematic rateless codes
have zero decode cost on the no-straggler fast path and O(R) peeling decode
otherwise — matching the paper's O(R) Raptor complexity argument (§2).

Degree neighbours are represented densely as ``(n_coded, d_max)`` index +
mask arrays so that encoding is a gather + masked-sum, which maps 1:1 onto
the fused ``coded_matmul`` kernel.

Port of ``repro.core.fountain``: the code construction and the symbolic
peeling plans are host-side numpy, copied verbatim so a JAX plan and a port
plan are the same object (``tests/test_torch_fountain.py`` pins the tables);
encoding and plan application are torch on the data's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ideal_soliton",
    "robust_soliton",
    "LTCode",
    "make_lt_code",
    "encode",
    "encode_ref",
    "DecodePlan",
    "PlanRound",
    "peel_decode_plan",
    "plan_step_rounds",
    "plan_rounds",
    "apply_decode_plan",
    "decode",
    "decode_failure_prob",
]


# ---------------------------------------------------------------------------
# Degree distributions
# ---------------------------------------------------------------------------

def ideal_soliton(R: int) -> np.ndarray:
    """Ideal soliton distribution rho(d), d = 1..R. Returns probs shape (R,)."""
    if R < 1:
        raise ValueError(f"R must be >= 1, got {R}")
    p = np.zeros(R, dtype=np.float64)
    p[0] = 1.0 / R
    d = np.arange(2, R + 1, dtype=np.float64)
    p[1:] = 1.0 / (d * (d - 1.0))
    return p


def robust_soliton(R: int, c: float = 0.03, delta: float = 0.5) -> np.ndarray:
    """Robust soliton distribution mu(d) (Luby'02), d = 1..R."""
    rho = ideal_soliton(R)
    S = c * np.log(R / delta) * np.sqrt(R) if R > 1 else 1.0
    S = max(S, 1.0)
    tau = np.zeros(R, dtype=np.float64)
    pivot = int(np.floor(R / S))
    pivot = min(max(pivot, 1), R)
    d = np.arange(1, R + 1, dtype=np.float64)
    head = d < pivot
    tau[head] = S / (R * d[head])
    tau[pivot - 1] = S * np.log(S / delta) / R if pivot >= 1 else 0.0
    mu = rho + tau
    mu = np.clip(mu, 0.0, None)
    return mu / mu.sum()


# ---------------------------------------------------------------------------
# Code construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LTCode:
    """A (systematic) LT code over ``R`` source blocks with ``K`` parities.

    idx:  (R+K, d_max) int32   — source-block neighbours of each coded block.
    mask: (R+K, d_max) bool    — validity of each neighbour slot.
    coef: (R+K, d_max) float32 — combination coefficients (systematic rows
          1.0; parity rows Rademacher ±1).  GF(2) XOR maps to real addition,
          and upgrading the all-ones combinations to random signs costs
          nothing on TPU (add vs. subtract) while making small-block loss
          patterns generically full-rank over the reals (the 0/1 version
          loses rank whenever two loss-set restrictions sum identically).
    R, K: ints.
    """

    idx: np.ndarray
    mask: np.ndarray
    coef: np.ndarray
    R: int
    K: int

    @property
    def n_coded(self) -> int:
        return self.R + self.K

    @property
    def d_max(self) -> int:
        return int(self.idx.shape[1])

    @property
    def weights(self) -> np.ndarray:
        """(R+K, d_max) float32 = mask * coef — the kernel/encode operand."""
        return (self.mask * self.coef).astype(np.float32)

    def degrees(self) -> np.ndarray:
        return self.mask.sum(axis=1).astype(np.int32)

    def dense_generator(self) -> np.ndarray:
        """(R+K, R) generator matrix (float32). For tests/small R only."""
        G = np.zeros((self.n_coded, self.R), dtype=np.float32)
        rows = np.repeat(np.arange(self.n_coded), self.d_max)
        cols = self.idx.reshape(-1)
        valid = self.mask.reshape(-1)
        vals = self.coef.reshape(-1)
        np.add.at(G, (rows[valid], cols[valid]), vals[valid])
        # repeated neighbour indices would double-count; construction avoids
        # them (sampling w/o replacement).
        return G


def make_lt_code(
    R: int,
    K: int,
    seed: int = 0,
    c: float = 0.03,
    delta: float = 0.5,
    d_max: Optional[int] = None,
    systematic: bool = True,
    coverage_min: int = 2,
    parity_degree: Optional[int] = None,
) -> LTCode:
    """Build a (systematic) LT code: R source (identity) + K parity blocks.

    ``parity_degree``: fixed degree for every parity instead of soliton
    sampling.  Dense parities (~R/2) make small-block erasure patterns
    generically full-rank (random ±1 matrix behaviour) at higher encode
    cost — used by placement-validated plans where encode adds are cheap
    relative to the fused matmul (core/coded_matmul.py); soliton stays the
    default for the paper-faithful O(R) codec.

    ``coverage_min`` (Raptor-style outer-code simplification): soliton
    coverage guarantees are asymptotic in R; for the small block counts used
    on a TPU mesh (tens of row-blocks), a source block covered by zero or one
    parity is a single point of failure (losing its systematic copy — or the
    copy plus its lone parity — is unrecoverable).  Every source is therefore
    appended round-robin to parity rows until it appears in at least
    ``coverage_min`` of them (capped at K).  Set 0 to disable (pure soliton).
    """
    if R < 1 or K < 0:
        raise ValueError(f"need R>=1, K>=0; got R={R} K={K}")
    rng = np.random.default_rng(seed)
    if parity_degree is not None:
        degs = np.full(K, min(max(parity_degree, 1), R), dtype=np.int64)
    else:
        probs = robust_soliton(R, c=c, delta=delta)
        # Parity degrees: resample degree-1 parities to >=2 when possible —
        # a degree-1 parity duplicates a systematic block, wasting overhead.
        degs = rng.choice(np.arange(1, R + 1), size=K, p=probs)
        if R >= 2:
            degs = np.where(degs < 2, 2, degs)
    if d_max is not None:
        degs = np.minimum(degs, d_max)
    nbr_sets = [
        set(rng.choice(R, size=int(degs[k]), replace=False).tolist())
        for k in range(K)
    ]
    if coverage_min > 0 and K > 0:
        want = min(coverage_min, K)
        counts = np.zeros(R, dtype=np.int64)
        for s in nbr_sets:
            for src in s:
                counts[src] += 1
        rr = list(rng.permutation(K))
        ptr = 0
        for src in np.flatnonzero(counts < want):
            while counts[src] < want:
                for _ in range(K):
                    tgt = int(rr[ptr % K])
                    ptr += 1
                    if src not in nbr_sets[tgt]:
                        nbr_sets[tgt].add(int(src))
                        counts[src] += 1
                        break
                else:
                    break  # source already in every parity
    nbr_sets = [sorted(s) for s in nbr_sets]
    eff_dmax = max((len(s) for s in nbr_sets), default=1)
    eff_dmax = max(eff_dmax, 1)
    if d_max is not None:
        eff_dmax = max(min(eff_dmax, max(d_max, 1)), 1)
        # Coverage-aware truncation: when trimming a parity to d_max, drop
        # its *most-covered* members first so no source silently loses its
        # only parity slot.
        counts = np.zeros(R, dtype=np.int64)
        for s in nbr_sets:
            for src in s:
                counts[src] += 1
        trimmed = []
        for s in nbr_sets:
            while len(s) > eff_dmax:
                drop = max(s, key=lambda src: (counts[src], src))
                s = [x for x in s if x != drop]
                counts[drop] -= 1
            trimmed.append(sorted(s))
        nbr_sets = trimmed
        # Repair pass: truncation may still zero a source's coverage when the
        # slot budget K*d_max is tight — swap it in over a member that is
        # covered elsewhere (count >= 2).
        for src in np.flatnonzero(counts == 0):
            done = False
            for s in nbr_sets:
                if done:
                    break
                for victim in sorted(s, key=lambda v: -counts[v]):
                    if counts[victim] >= 2 and src not in s:
                        s.remove(victim)
                        s.append(int(src))
                        s.sort()
                        counts[victim] -= 1
                        counts[src] += 1
                        done = True
                        break
        nbr_sets = [sorted(s) for s in nbr_sets]
    n_coded = R + K if systematic else K
    idx = np.zeros((n_coded, eff_dmax), dtype=np.int32)
    mask = np.zeros((n_coded, eff_dmax), dtype=bool)
    coef = np.zeros((n_coded, eff_dmax), dtype=np.float32)
    row = 0
    if systematic:
        idx[:R, 0] = np.arange(R, dtype=np.int32)
        mask[:R, 0] = True
        coef[:R, 0] = 1.0
        row = R
    for k in range(K):
        d = len(nbr_sets[k])
        idx[row + k, :d] = np.asarray(nbr_sets[k], dtype=np.int32)
        mask[row + k, :d] = True
        coef[row + k, :d] = rng.choice(np.array([-1.0, 1.0], np.float32), size=d)
    return LTCode(idx=idx, mask=mask, coef=coef, R=R, K=K)


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def encode_ref(blocks: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain oracle: coded[b] = sum_j mask[b,j] * blocks[idx[b,j]].

    blocks: (R, *rest); idx/mask: (n_coded, d_max). Returns (n_coded, *rest).
    """
    gathered = blocks[idx.long()]  # (n_coded, d_max, *rest)
    m = mask.to(blocks.dtype)
    m = m.reshape(m.shape + (1,) * (gathered.dim() - m.dim()))
    return (gathered * m).sum(dim=1)


def encode(blocks: torch.Tensor, code: LTCode) -> torch.Tensor:
    """Encode source blocks (R, *rest) -> coded blocks (R+K, *rest)."""
    if blocks.shape[0] != code.R:
        raise ValueError(f"blocks.shape[0]={blocks.shape[0]} != R={code.R}")
    dev = blocks.device
    return encode_ref(blocks, torch.as_tensor(code.idx, device=dev),
                      torch.as_tensor(code.weights, device=dev))


# ---------------------------------------------------------------------------
# Decoding: symbolic peeling plan (host) + torch application (device)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Schedule produced by peeling. Applying it reconstructs all R sources.

    direct_src / direct_coded / direct_coef: sources recovered from received
        degree-1 blocks (systematic fast path), aligned 1:1; the value is
        coded/coef.
    order_coded: (T,) coded-block position (into the *received* array) used at
        step t.
    order_src:   (T,) source index recovered at step t.
    order_pivot: (T,) coefficient of the recovered source in that block.
    order_nbr_idx / order_nbr_coef: (T, d_max) other neighbours of that coded
        block (all recovered before step t) and their coefficients to
        subtract (coef 0 = padding).
    """

    direct_src: np.ndarray
    direct_coded: np.ndarray
    direct_coef: np.ndarray
    order_coded: np.ndarray
    order_src: np.ndarray
    order_pivot: np.ndarray
    order_nbr_idx: np.ndarray
    order_nbr_coef: np.ndarray
    R: int

    @property
    def n_peeled(self) -> int:
        return int(self.order_src.shape[0])


def peel_decode_plan(
    code: LTCode, received_ids: np.ndarray
) -> Optional[DecodePlan]:
    """Run symbolic peeling over the received coded blocks.

    received_ids: indices into the coded space (0..R+K-1) of blocks that
    arrived. Returns a DecodePlan, or None if peeling stalls before
    recovering all R sources (caller may retry with more blocks or use the
    dense fallback in :func:`decode`).
    """
    received_ids = np.asarray(received_ids, dtype=np.int64)
    R, d_max = code.R, code.d_max
    n_rx = received_ids.shape[0]
    # Neighbour sets of received blocks (as growing/shrinking residual graph)
    # plus per-(block, source) coefficients.
    nbrs = [set(code.idx[b, code.mask[b]].tolist()) for b in received_ids]
    coef_of = [
        {int(s): float(c) for s, c in
         zip(code.idx[b, code.mask[b]], code.coef[b, code.mask[b]])}
        for b in received_ids
    ]
    known = np.zeros(R, dtype=bool)

    direct_src, direct_coded, direct_coef = [], [], []
    order_coded, order_src, order_pivot, order_nbrs = [], [], [], []

    # Fast path: degree-1 received blocks give sources directly.
    ripple = []
    for pos in range(n_rx):
        if len(nbrs[pos]) == 1:
            s = next(iter(nbrs[pos]))
            if not known[s]:
                known[s] = True
                direct_src.append(s)
                direct_coded.append(pos)
                direct_coef.append(coef_of[pos][s])
                ripple.append(s)
            nbrs[pos] = set()

    # Build reverse map: source -> received block positions containing it.
    contains: dict[int, list[int]] = {}
    for pos in range(n_rx):
        for s in nbrs[pos]:
            contains.setdefault(s, []).append(pos)

    residual_deg = np.array([len(x) for x in nbrs], dtype=np.int64)
    # Peel: subtract known sources; blocks reaching residual degree 1 release
    # a new source.
    pending = list(ripple)
    # Also blocks that already have all-but-one neighbour known.
    while True:
        while pending:
            s = pending.pop()
            for pos in contains.get(s, ()):  # blocks containing s
                if s in nbrs[pos]:
                    nbrs[pos].discard(s)
                    residual_deg[pos] -= 1
                    if residual_deg[pos] == 1:
                        t = next(iter(nbrs[pos]))
                        if not known[t]:
                            known[t] = True
                            # other neighbours of this coded block = original
                            # neighbours minus t — all known at this point.
                            all_nb = set(
                                code.idx[received_ids[pos], code.mask[received_ids[pos]]].tolist()
                            )
                            others = sorted(all_nb - {t})
                            order_coded.append(pos)
                            order_src.append(t)
                            order_pivot.append(coef_of[pos][t])
                            order_nbrs.append(
                                [(o, coef_of[pos][o]) for o in others]
                            )
                            pending.append(t)
                        nbrs[pos] = set()
                        residual_deg[pos] = 0
        if known.all():
            break
        # stalled
        return None

    T = len(order_src)
    nbr_idx = np.zeros((T, d_max), dtype=np.int32)
    nbr_coef = np.zeros((T, d_max), dtype=np.float32)
    for t, others in enumerate(order_nbrs):
        for j, (o, c) in enumerate(others):
            nbr_idx[t, j] = o
            nbr_coef[t, j] = c
    return DecodePlan(
        direct_src=np.asarray(direct_src, dtype=np.int32),
        direct_coded=np.asarray(direct_coded, dtype=np.int32),
        direct_coef=np.asarray(direct_coef, dtype=np.float32),
        order_coded=np.asarray(order_coded, dtype=np.int32),
        order_src=np.asarray(order_src, dtype=np.int32),
        order_pivot=np.asarray(order_pivot, dtype=np.float32),
        order_nbr_idx=nbr_idx,
        order_nbr_coef=nbr_coef,
        R=R,
    )


@dataclasses.dataclass(frozen=True)
class PlanRound:
    """One dependency level of a peeling plan (see :func:`plan_rounds`).

    All ``S`` sources of a round depend only on sources recovered in earlier
    rounds (or directly), so the whole round is one batched masked
    gather-subtract — the unit of work of the ``kernels/lt_decode`` Pallas
    kernel.  ``coded``/``src``/``pivot`` are (S,); ``nbr_idx``/``nbr_coef``
    are (S, d_max) with coef 0 = padding.
    """

    coded: np.ndarray
    src: np.ndarray
    pivot: np.ndarray
    nbr_idx: np.ndarray
    nbr_coef: np.ndarray

    @property
    def size(self) -> int:
        return int(self.src.shape[0])


def plan_step_rounds(plan: DecodePlan) -> np.ndarray:
    """The round of each peeled step of ``plan`` (see :func:`plan_rounds`),
    (T,) int64, computed over all steps at once: each pass gives every step
    ``1 + max(round of the steps that recovered its neighbours)``, direct
    sources counting 0, until nothing changes.  A plan recovers each source
    once, as :func:`peel_decode_plan`'s do."""
    T = plan.n_peeled
    producer = np.full(plan.R, T, dtype=np.int64)  # T: never recovered
    producer[plan.order_src[::-1]] = np.arange(T - 1, -1, -1)
    producer[plan.direct_src] = -1
    prod = np.where(plan.order_nbr_coef != 0, producer[plan.order_nbr_idx], -1)
    assert (prod < np.arange(T)[:, None]).all(), \
        "plan step depends on an unrecovered source"
    prod[prod < 0] = T  # the slot of direct sources and padding, round 0
    ext = np.zeros(T + 1, dtype=np.int64)
    ext[:T] = 1
    while T:
        step = 1 + ext[prod].max(axis=1, initial=0)
        if np.array_equal(step, ext[:T]):
            break
        ext[:T] = step
    return ext[:T]


def plan_rounds(plan: DecodePlan) -> list:
    """Levelize a sequential :class:`DecodePlan` into parallel rounds.

    Step ``t`` recovers ``order_src[t]`` by subtracting already-recovered
    neighbours; its *round* is ``1 + max(round of those neighbours)`` with
    directly-received (degree-1) sources at round 0.  Steps inside one round
    are mutually independent, so a round executes as a single batched peel —
    the round count is the decode's critical path, typically O(log R) deep
    versus the O(R) sequential scan of :func:`apply_decode_plan`.
    """
    step_round = plan_step_rounds(plan)
    rounds = []
    for d in range(1, int(step_round.max(initial=0)) + 1):
        sel = np.flatnonzero(step_round == d)
        rounds.append(PlanRound(
            coded=plan.order_coded[sel],
            src=plan.order_src[sel],
            pivot=plan.order_pivot[sel],
            nbr_idx=plan.order_nbr_idx[sel],
            nbr_coef=plan.order_nbr_coef[sel],
        ))
    return rounds


def apply_decode_plan(coded_rx: torch.Tensor, plan: DecodePlan) -> torch.Tensor:
    """Apply a peeling plan to received coded blocks (n_rx, *rest) -> (R, *rest).

    One step per recovered source, in plan order (the reference's
    ``lax.scan``); ``src`` is updated in place.
    """
    rest = coded_rx.shape[1:]
    dev, dt = coded_rx.device, coded_rx.dtype
    src = torch.zeros((plan.R,) + rest, dtype=dt, device=dev)
    if plan.direct_src.size:
        dcoef = torch.as_tensor(plan.direct_coef, device=dev).to(dt)
        coded = coded_rx[torch.as_tensor(plan.direct_coded, device=dev).long()]
        src[torch.as_tensor(plan.direct_src, device=dev).long()] = (
            coded / dcoef.reshape((-1,) + (1,) * len(rest)))
    if plan.order_src.size == 0:
        return src
    nbr_idx = torch.as_tensor(plan.order_nbr_idx, device=dev).long()
    nbr_coef = torch.as_tensor(plan.order_nbr_coef, device=dev).to(dt)
    pivot = torch.as_tensor(plan.order_pivot, device=dev).to(dt)
    for t in range(plan.n_peeled):
        c = coded_rx[int(plan.order_coded[t])]
        gathered = src[nbr_idx[t]]  # (d_max, *rest)
        w = nbr_coef[t].reshape((-1,) + (1,) * len(rest))
        src[int(plan.order_src[t])] = (c - (gathered * w).sum(dim=0)) / pivot[t]
    return src


def decode(
    coded_rx: torch.Tensor,
    code: LTCode,
    received_ids: np.ndarray,
) -> Tuple[torch.Tensor, str]:
    """Decode received coded blocks back to the R source blocks.

    Tries O(R) peeling first; falls back to a dense least-squares solve over
    the real generator rows on the data's device — always succeeds when the
    received rows span the source space (rank-checked on the host, which
    also guarantees the full-rank tall system CUDA's ``gels`` driver needs).
    On a CUDA tensor the peel is one launch of the LT decode kernel (K3,
    :func:`repro_torch.kernels.lt_decode.lt_decode` with ``scan=True``, the
    steps in plan order as :func:`apply_decode_plan` takes them) over the
    blocks flattened to rows, and a type that kernel does not take (float32,
    bfloat16) raises; a CPU tensor takes :func:`apply_decode_plan`.
    Returns (blocks, method).
    """
    plan = peel_decode_plan(code, received_ids)
    if plan is not None:
        if not coded_rx.is_cuda:
            return apply_decode_plan(coded_rx, plan), "peel"
        from ..kernels.lt_decode import lt_decode  # its ops module imports this one
        rest = coded_rx.shape[1:]
        flat = coded_rx.reshape(coded_rx.shape[0], -1)  # a view of contiguous blocks
        return lt_decode(flat, plan, bm=1, scan=True).view((plan.R,) + rest), "peel"
    G = code.dense_generator()[np.asarray(received_ids)]  # (n_rx, R)
    if np.linalg.matrix_rank(G) < code.R:
        raise ValueError("received blocks do not span the source space")
    flat = coded_rx.reshape(coded_rx.shape[0], -1).to(torch.float32)
    sol = torch.linalg.lstsq(
        torch.as_tensor(G, device=coded_rx.device), flat).solution
    return sol.reshape((code.R,) + coded_rx.shape[1:]).to(coded_rx.dtype), "dense"


def decode_failure_prob(
    R: int, K: int, n_lost: int, trials: int = 200, seed: int = 0
) -> dict:
    """Monte-Carlo decode-failure statistics when ``n_lost`` coded blocks
    (uniform w/o replacement) are missing. Returns
    ``{'peel_stall': p1, 'unrecoverable': p2}`` — a peel stall falls back to
    the dense O(R^3) solve (still succeeds when the received rows span the
    source space); 'unrecoverable' means even that fails (rank deficiency).
    Used by benchmarks/overhead.py."""
    rng = np.random.default_rng(seed)
    stalls = 0
    unrec = 0
    for t in range(trials):
        code = make_lt_code(R, K, seed=seed * 7919 + t)
        lost = rng.choice(R + K, size=n_lost, replace=False)
        keep = np.setdiff1d(np.arange(R + K), lost)
        if peel_decode_plan(code, keep) is None:
            stalls += 1
            G = code.dense_generator()[keep]
            if np.linalg.matrix_rank(G) < R:
                unrec += 1
    return {"peel_stall": stalls / trials, "unrecoverable": unrec / trials}
