"""Closed-form theory from the paper (Theorems 1-3 and §4-§5).

A verbatim copy of ``repro.core.theory`` (pure numpy), kept here so the port
imports nothing of the JAX package; ``tests/test_torch_ccp.py`` pins it.

All formulas keep the paper's notation:
  beta_{n,i} ~ shifted exponential, shift a_n, rate mu_n, mean a_n + 1/mu_n.
  RTT^data_n — per-helper data round-trip time.
  R packets + K coding overhead.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "shifted_exp_mean",
    "expected_underutilization",
    "efficiency",
    "t_opt_model1",
    "t_opt_model2_realized",
    "t_opt_model2_upper",
    "optimal_allocation",
]


def shifted_exp_mean(a, mu):
    """E[beta] = a + 1/mu."""
    a = np.asarray(a, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    return a + 1.0 / mu


def expected_underutilization(rtt_data, mu):
    """Theorem 1 / eq. (11): E[Tu_{n,i}] per packet.

    E[Tu] = RTT + (1/mu)(e^{-1} - e^{mu RTT - 1})   if RTT < 1/mu
          = (1/(e mu))                              otherwise
    """
    rtt = np.asarray(rtt_data, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    small = rtt < 1.0 / mu
    e_small = rtt + (np.exp(-1.0) - np.exp(np.minimum(mu * rtt, 1.0) - 1.0)) / mu
    e_large = 1.0 / (np.e * mu)
    return np.where(small, e_small, e_large)


def efficiency(rtt_data, a, mu):
    """eq. (12): gamma_n = 1 - E[Tu_{n,i}] / E[beta_{n,i}]."""
    return 1.0 - expected_underutilization(rtt_data, mu) / shifted_exp_mean(a, mu)


def t_opt_model1(R, K, a, mu):
    """Theorem 2 / eq. (27): T_opt = (R+K) / sum_n mu_n/(1 + a_n mu_n)."""
    a = np.asarray(a, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    return (R + K) / np.sum(mu / (1.0 + a * mu))


def t_opt_model2_realized(R, K, beta):
    """Theorem 3 / eq. (29): T_opt = (R+K) / sum_n 1/beta_n for realized beta_n."""
    beta = np.asarray(beta, dtype=np.float64)
    return (R + K) / np.sum(1.0 / beta)


def t_opt_model2_upper(R, K, a, mu):
    """eq. (30): E[T_opt] <= (R+K) / sum_n mu_n/(1 + a_n mu_n)."""
    return t_opt_model1(R, K, a, mu)


def optimal_allocation(R, K, e_beta):
    """eq. (23): r_n^opt = (R+K) / (E[beta_n] * sum_m 1/E[beta_m]).

    Returns real-valued loads summing to R+K (integerize via largest
    remainder where needed).
    """
    e_beta = np.asarray(e_beta, dtype=np.float64)
    inv = 1.0 / e_beta
    return (R + K) * inv / inv.sum()


def largest_remainder_round(loads, total: int) -> np.ndarray:
    """Round non-negative real loads to ints summing exactly to ``total``."""
    loads = np.asarray(loads, dtype=np.float64)
    base = np.floor(loads).astype(np.int64)
    short = int(total - base.sum())
    if short < 0:  # defensive: loads summed above total
        order = np.argsort(loads - base)
        for i in order[: -short]:
            base[i] = max(base[i] - 1, 0)
        return base
    frac = loads - base
    order = np.argsort(-frac)
    base[order[:short]] += 1
    return base
