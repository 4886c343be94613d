"""Beyond-paper figure: completion delay and efficiency under churn.
T is simulated seconds.

Extends the paper's adaptivity claim (§1, §6: "adaptive to time-varying
resources") to three loss regimes, each a sweep:

  iid    — i.i.d. per-packet loss on top of phase outages and slowdowns
  burst  — Gilbert–Elliott burst loss per helper; the axis is the
           good->bad transition prob (the stationary loss rate at a fixed
           burstiness)
  cell   — correlated whole-cell outages of log-normal duration; the axis
           is the per-phase event probability

all of which run Algorithm 1's lines 13-14 (timeout, backoff, retransmit)
in the engine loop.  Setup: Fig.-4-style heterogeneity (mu ~ U{1,3,9},
a_n = 1/mu_n) on 1-2 Mbps links.  CCP's per-helper adapted timeout should
degrade gracefully toward Best; Naive's timer is provisioned for the
slowest class and its delay grows with the loss rate; ``naive_oracle``
separates Naive's pipelining loss from its timer loss; ``adaptive_rate``
adapts the fountain overhead to the measured loss.

Uncertified reps (horizon cap hit) are dropped and counted per point
(``invalid``), never averaged.  Port of ``benchmarks/fig_churn.py``.
"""

from __future__ import annotations

import time

import numpy as np

from ..core import engine, simulator
from .common import _stats, certified, emit, policy_meta

N = 50
R = 1000
MU_CHOICES = (1.0, 3.0, 9.0)
POLICIES = ("ccp", "best", "naive", "naive_oracle", "adaptive_rate")

DROP_SWEEP = (0.0, 0.05, 0.1, 0.2, 0.3)
# GE good->bad sweep at fixed recovery (p_good=0.25) and bad-state loss 0.9:
# stationary loss = 0.9 * pb / (pb + 0.25) -> ~0, 3.4%, 9.6%, 17.4%.
BURST_SWEEP = (0.0, 0.01, 0.03, 0.06)
# Per-phase whole-cell outage event probability.
CELL_SWEEP = (0.0, 0.1, 0.25, 0.5)


def _base(churn: simulator.ChurnConfig, n: int = N) -> simulator.ScenarioConfig:
    return simulator.ScenarioConfig(
        N=n, scenario=1, mu_choices=MU_CHOICES, a_mode="inv_mu",
        rate_lo=1e6, rate_hi=2e6, churn=churn)


def iid_cfg(drop_prob: float, n: int = N) -> simulator.ScenarioConfig:
    return _base(simulator.ChurnConfig(
        period=10.0, p_down=0.05, p_slow=0.1, slowdown=4.0,
        drop_prob=drop_prob, max_backoff=8.0), n)


def burst_cfg(ge_p_bad: float, n: int = N) -> simulator.ScenarioConfig:
    return _base(simulator.ChurnConfig(
        period=10.0, max_backoff=8.0,
        ge_p_bad=ge_p_bad, ge_p_good=0.25, ge_loss_good=0.0,
        ge_loss_bad=0.9), n)


def cell_cfg(p_cell: float, n: int = N) -> simulator.ScenarioConfig:
    # Mild background packet loss (fixed across the sweep) on top of the
    # swept correlated-outage rate: the policies separate on how each timer
    # recovers around the outages.
    return _base(simulator.ChurnConfig(
        period=5.0, max_backoff=8.0, drop_prob=0.1,
        p_cell=p_cell, cell_frac=0.6,
        outage_dist="lognormal", outage_mean=4.0, outage_sigma=0.5), n)


SWEEPS = {
    "iid": (DROP_SWEEP, iid_cfg, "drop_prob"),
    "burst": (BURST_SWEEP, burst_cfg, "ge_p_bad"),
    "cell": (CELL_SWEEP, cell_cfg, "p_cell"),
}


def _policy_stats(out) -> dict:
    """Per-policy stats with uncertified reps dropped and counted."""
    valid = certified(out, "fig_churn")
    return {
        **_stats(out.T.cpu().numpy()[valid]),
        "invalid": int((~valid).sum()),
        "efficiency": float(np.nanmean(out.efficiency.cpu().numpy()[valid])),
        "lost_frac": float(out.lost_frac.cpu().numpy()[valid].mean()),
        "max_backoff": float(out.max_backoff.cpu().numpy()[valid].max()),
        "M": out.M,
    }


def run(reps: int = 40, sweeps=None, R: int = R, n_helpers: int = N,
        policies=POLICIES, *, device=None, seed: int = 0, out_dir=None) -> dict:
    sweeps = dict(SWEEPS) if sweeps is None else sweeps
    policies = tuple(policies)
    eng = engine.Engine(device=device)
    t0 = time.perf_counter()
    rows, summary, walls = [], {}, {}
    for sweep_name, (axis, mk_cfg, axis_name) in sweeps.items():
        t_sweep = time.perf_counter()
        sweep_rows = []
        for x in axis:
            cfg = mk_cfg(x, n_helpers)
            row = {"sweep": sweep_name, axis_name: x, "R": R, "N": n_helpers}
            if cfg.churn.ge_enabled:
                row["ge_loss_rate"] = cfg.churn.ge_loss_rate
            for p in policies:
                row[p] = _policy_stats(eng.run(cfg, p, reps, R, seed=seed))
            if "best" in policies:
                for p in policies:
                    if p != "best":
                        row[f"{p}_vs_best"] = row[p]["mean"] / row["best"]["mean"]
            sweep_rows.append(row)
        walls[sweep_name] = time.perf_counter() - t_sweep
        rows.extend(sweep_rows)
        # Each policy's degradation across the sweep, relative to its own
        # delay at the sweep's first point.
        for p in policies:
            summary[f"{sweep_name}_{p}_degradation"] = (
                sweep_rows[-1][p]["mean"] / sweep_rows[0][p]["mean"])
            if p != "best" and "best" in policies:
                summary[f"{sweep_name}_{p}_vs_best_worst"] = max(
                    r[f"{p}_vs_best"] for r in sweep_rows)
        if "ccp" in policies and "adaptive_rate" in policies:
            summary[f"{sweep_name}_adaptive_rate_vs_ccp"] = (
                sweep_rows[-1]["adaptive_rate"]["mean"] / sweep_rows[-1]["ccp"]["mean"])
        summary[f"{sweep_name}_invalid_total"] = sum(
            r[p]["invalid"] for r in sweep_rows for p in policies)
    wall = time.perf_counter() - t0
    emit("fig_churn", rows, device=eng.device, seed=seed, wall_s=wall,
         policies=policy_meta(policies), out_dir=out_dir,
         derived=";".join(f"{k}={v:.3f}" for k, v in summary.items()))
    return {"rows": rows, "summary": summary, "policies": policies, "wall_s": wall,
            "sweep_wall_s": walls}
