"""Baselines from §6: Uncoded (two allocations) and HCMM [Reisizadeh et al.],
as the sequential reference path.

Uncoded: ``r_n`` *uncoded* packets are pre-assigned to helper ``n`` (summing
to exactly R, so *every* helper must finish).  Two allocation rules from the
paper: proportional to 1/E[beta_n] ('mean') and proportional to mu_n ('mu').

HCMM (arXiv:1701.05973): each helper gets a fixed block of MDS-coded rows,
sized by the asymptotically-optimal load; the collector finishes when the
loads of *fully finished* helpers sum to >= R.  Load solver: helper n's
per-time expected useful rate is rho(lmbda) = lmbda * (1 - e^{mu a - mu/lmbda});
the optimum lmbda* solves  ln(1 + u + mu*a) = u  with  u = mu/lmbda - mu*a,
then tau* = R / sum_n rho_n(lmbda_n*)  and  ell_n = lmbda_n* tau*.

Port of ``repro.core.baselines``.  The allocations are plain numpy float64
copies.  The reference's timing scan is split the way the engine is: a
function on drawn tables (:func:`block_finish_times`, a loop over the M
packets) and a drawing wrapper on a ``torch.Generator``
(:func:`_block_finish_times`), so tests can feed it tables the reference
drew.  The batched in-loop equivalents are the ``uncoded_mean``,
``uncoded_mu`` and ``hcmm`` policies of :class:`~repro_torch.core.engine.Engine`.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import _device
from . import engine, theory
from . import simulator as sim

__all__ = ["uncoded_allocation", "hcmm_loads", "block_finish_times",
           "run_uncoded", "run_hcmm"]


# ---------------------------------------------------------------------------
# Allocations
# ---------------------------------------------------------------------------

def uncoded_allocation(R: int, mu, a, rule: str) -> np.ndarray:
    """Integer loads summing to R; rule in {'mean', 'mu'}."""
    mu = np.asarray(mu, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    if rule == "mean":
        w = 1.0 / theory.shifted_exp_mean(a, mu)
    elif rule == "mu":
        w = mu.copy()
    else:
        raise ValueError(f"unknown rule {rule!r}")
    loads = R * w / w.sum()
    return theory.largest_remainder_round(loads, R)


def _hcmm_u_star(mu_a: float) -> float:
    """Solve ln(1 + u + mu*a) = u for u > 0 (Newton; unique positive root)."""
    u = max(mu_a, 1.0)
    for _ in range(100):
        f = np.log1p(u + mu_a) - u
        fp = 1.0 / (1.0 + u + mu_a) - 1.0
        step = f / fp
        u_new = u - step
        if u_new <= 0:
            u_new = u / 2.0
        if abs(u_new - u) < 1e-12:
            u = u_new
            break
        u = u_new
    return float(u)


def hcmm_loads(R: int, mu, a) -> np.ndarray:
    """HCMM asymptotically-optimal per-helper loads (integers)."""
    mu = np.asarray(mu, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    lam = np.empty_like(mu)
    rho = np.empty_like(mu)
    for n in range(mu.shape[0]):
        u = _hcmm_u_star(mu[n] * a[n])
        lam[n] = mu[n] / (u + mu[n] * a[n])
        rho[n] = lam[n] * (1.0 - np.exp(-u))
    tau = R / rho.sum()
    loads = lam * tau
    total = int(np.ceil(loads.sum()))
    return theory.largest_remainder_round(loads, total)


# ---------------------------------------------------------------------------
# Simulation of block-assigned baselines
# ---------------------------------------------------------------------------

def block_finish_times(beta, d_up, d_down, loads) -> torch.Tensor:
    """Finish time (last computed result at the collector) per helper of a
    fixed pre-assigned block of ``loads[n]`` packets, streamed back to back,
    from drawn tables (N, M) and loads (N,); 0 for an empty block."""
    # Uplink serialized: packet i arrives at cumsum(d_up)[i].
    arrive = torch.cumsum(d_up, dim=-1)
    done = torch.zeros_like(arrive[..., 0])
    cols = []
    for i in range(beta.shape[-1]):
        done = torch.maximum(arrive[..., i], done) + beta[..., i]
        cols.append(done)
    tr = torch.stack(cols, dim=-1) + d_down
    loads = torch.as_tensor(loads, device=tr.device)
    idx = torch.clamp(loads.long() - 1, 0, tr.shape[-1] - 1)
    t_n = torch.gather(tr, -1, idx[..., None])[..., 0]
    return torch.where(loads > 0, t_n, 0.0)


def _block_finish_times(gen: torch.Generator, cfg, R: int, loads: np.ndarray,
                        mu, a, rate, M_override: Optional[int] = None) -> np.ndarray:
    """Draw one rep's packet tables from ``gen`` and return its block finish
    times (N,) as numpy.  The tables are drawn at ``M = loads.max()``, or at
    ``M_override`` (>= the largest load) to match the engine's shared
    horizon draw for draw."""
    M = M_override if M_override is not None else int(loads.max())
    if M == 0:
        return np.zeros(cfg.N)
    beta, d_up, _d_ack, d_down = sim.draw_packet_tables(
        gen, cfg, mu[None], a[None], rate[None], M, R)
    return block_finish_times(beta[0], d_up[0], d_down[0], loads).cpu().numpy()


def _draw_helpers(cfg, seed, device):
    gen = engine._generator(seed, _device.resolve(device))
    mu, a, rate = sim.draw_helpers(gen, cfg, 1)
    return gen, mu[0], a[0], rate[0]


def run_uncoded(cfg, R: int, rule: str = "mean", *,
                seed: Union[int, torch.Generator] = 0, device=None,
                M_override: Optional[int] = None) -> Dict:
    """Uncoded baseline: every helper must finish its block; T = max_n.

    One rep drawn from ``seed`` (an int or a ``torch.Generator`` on
    ``device``, CUDA unless the caller names another).  Returns the
    reference's dict: ``T`` (a float), ``loads``, ``mu``, ``a`` (numpy)."""
    engine._check_R(R)
    gen, mu, a, rate = _draw_helpers(cfg, seed, device)
    mu_np, a_np = mu.cpu().numpy(), a.cpu().numpy()
    loads = uncoded_allocation(R, mu_np, a_np, rule)
    t_n = _block_finish_times(gen, cfg, R, loads, mu, a, rate, M_override)
    return dict(T=float(np.max(t_n)), loads=loads, mu=mu_np, a=a_np)


def run_hcmm(cfg, R: int, *, seed: Union[int, torch.Generator] = 0, device=None,
             M_override: Optional[int] = None) -> Dict:
    """HCMM: completion when finished helpers' loads sum to >= R (one rep,
    drawn as in :func:`run_uncoded`)."""
    engine._check_R(R)
    gen, mu, a, rate = _draw_helpers(cfg, seed, device)
    mu_np, a_np = mu.cpu().numpy(), a.cpu().numpy()
    loads = hcmm_loads(R, mu_np, a_np)
    t_n = _block_finish_times(gen, cfg, R, loads, mu, a, rate, M_override)
    order = np.argsort(t_n)
    agg = np.cumsum(loads[order])
    pos = int(np.searchsorted(agg, R))
    if pos >= cfg.N:  # insufficient aggregate redundancy (shouldn't happen)
        pos = cfg.N - 1
    return dict(T=float(t_n[order][pos]), loads=loads, mu=mu_np, a=a_np)
