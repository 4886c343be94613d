"""Coded gradient aggregation: R-of-(R+K) straggler-tolerant data parallelism
(port of ``repro.core.gradient_coding``).

The paper's fountain-coded sub-tasks, applied to DP training: the "task" is
the gradient sum over R microbatch shards; each worker returns its own shard
gradient (systematic block) and a subset of workers *additionally* compute a
parity — the gradient of a sparse sum of neighbour microbatches (extra
forward/backward = the coding redundancy, exactly the paper's K overhead).
The optimizer step needs any decodable R-subset of the R+K results, so up to
``s`` stragglers/failures per step cost nothing.

The survivor set is chosen before dispatch (from CCP heartbeat telemetry)
and realized as per-worker decode weights in a weighted sum, so the same
step serves every survivor pattern: the weights are a (tiny) input.

``decode_weights`` solves  w @ G_rx = 1_R : a combination of the received
coded rows equal to the all-ones row recovers the *sum* of all R source
gradients (we never need the individual blocks — cheaper than full decode).

The numpy code is the reference's, copied, on the port's
``core.fountain.make_lt_code``; :func:`coded_grad_sum` works on tensors.
Nothing here calls a kernel: the weighted sum is not an LT encode (K2).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .fountain import LTCode, make_lt_code


def make_gradient_code(n_workers: int, n_parity: int, seed: int = 0,
                       d_max: Optional[int] = None) -> LTCode:
    """LT code over R=n_workers microbatch-gradient blocks with K parities.

    Parity degrees are capped (default 4) — a parity's degree is the number
    of *extra* microbatch gradients some worker must compute, i.e. compute
    redundancy, so small degrees matter more than soliton fidelity here.
    """
    return make_lt_code(
        R=n_workers, K=n_parity, seed=seed,
        d_max=d_max if d_max is not None else 4,
        coverage_min=2 if n_parity >= 2 else n_parity,
    )


def parity_assignments(code: LTCode) -> list:
    """parity k -> tuple of source worker ids whose microbatches it re-runs.

    Parity k is assigned to worker k % R (round-robin), so redundancy spreads
    evenly; worker w computes parities {k : k % R == w}.
    """
    out = []
    for k in range(code.K):
        row = code.R + k
        nbrs = code.idx[row][code.mask[row]]
        out.append(tuple(int(x) for x in nbrs))
    return out


def decode_weights(code: LTCode, survivors: Sequence[int]) -> np.ndarray:
    """Solve for w with  w @ G[survivors] = 1_R  (gradient-sum recovery).

    survivors: indices into the coded space (0..R+K-1) that returned.
    Returns w (len(survivors),); raises ValueError if the pattern is
    undecodable (caller falls back to waiting / elastic restart).
    """
    G = code.dense_generator()[np.asarray(survivors)]
    ones = np.ones(code.R)
    w, res, rank, _ = np.linalg.lstsq(G.T, ones, rcond=None)
    if not np.allclose(G.T @ w, ones, atol=1e-6):
        raise ValueError(
            f"survivor set {list(survivors)} cannot recover the gradient sum"
        )
    return w.astype(np.float32)


def weight_table(code: LTCode, max_stragglers: int, seed: int = 0,
                 n_patterns: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Precompute decode weights for sampled straggler patterns.

    Returns (patterns (P, R+K) bool of survivors, weights (P, R+K) with
    zeros at non-survivors).  Pattern 0 is the no-straggler case (weights =
    systematic ones, parities zero — the fast path costs nothing).
    """
    rng = np.random.default_rng(seed)
    n = code.R + code.K
    pats, ws = [], []
    full = np.ones(n, bool)
    w0 = np.zeros(n, np.float32)
    w0[: code.R] = 1.0
    pats.append(full)
    ws.append(w0)
    tries = 0
    while len(pats) < n_patterns and tries < n_patterns * 20:
        tries += 1
        s = rng.integers(1, max_stragglers + 1)
        lost = rng.choice(n, size=s, replace=False)
        surv = np.setdiff1d(np.arange(n), lost)
        try:
            w = decode_weights(code, surv)
        except ValueError:
            continue
        pat = np.zeros(n, bool)
        pat[surv] = True
        wfull = np.zeros(n, np.float32)
        wfull[surv] = w
        pats.append(pat)
        ws.append(wfull)
    return np.stack(pats), np.stack(ws)


def coded_grad_sum(
    grads: torch.Tensor,      # (R, ...) systematic per-worker gradients
    parities: torch.Tensor,   # (K, ...) parity gradients
    weights,                  # (R+K,) decode weights (0 at non-survivors)
) -> torch.Tensor:
    """sum_n g_n from any decodable weighted subset (vectorized test path)."""
    coded = torch.cat([grads, parities], dim=0)
    w = torch.as_tensor(weights, device=coded.device).reshape(
        (-1,) + (1,) * (coded.dim() - 1)).to(coded.dtype)
    return (coded * w).sum(dim=0)


def expected_redundancy(code: LTCode) -> float:
    """Extra compute fraction: sum of parity degrees / R (the paper's K
    overhead translated to FLOPs)."""
    degs = code.degrees()[code.R:]
    return float(degs.sum()) / code.R
