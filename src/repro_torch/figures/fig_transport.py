"""Beyond-paper figure: the price of delayed feedback.  T is simulated
seconds.

The paper's Algorithm 1 paces on receipts observed the instant they
arrive; the transport layer (:mod:`repro_torch.core.transport`) makes the
feedback channel physical: each ACK rides a per-helper RTT process and can
itself be lost (one NACK retransmission round).  This figure sweeps the
mean feedback RTT across three churn/RTT regimes:

  iid    i.i.d. packet drops, *fixed* return-path RTT (a provisioned link)
  burst  Gilbert–Elliott burst fades, *lognormal* RTT jitter (WiFi)
  cell   correlated cell outages, *cell-spike* RTT (the return path
         occasionally inflates 10x)

and reports completion delay and efficiency per policy:

  * ``best`` is open-loop (oracle pacing reads no feedback): its curve is
    flat by construction, the control of the experiment;
  * ``ccp`` pays for late observations twice: pacing stalls on delayed
    receipts, and every loss is detected one or two RTTs late;
  * ``tfrc_ccp`` answers a fade with one congestion signal (the RFC 5348
    loss-event rate) instead of a per-lost-packet backoff cascade.

Uncertified reps are dropped and counted, never averaged.  The JSON
carries ``meta.rtt``: the swept means and each regime's RTT parameters.
Port of ``benchmarks/fig_transport.py``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core import engine, simulator
from .common import _stats, certified, emit, policy_meta

N = 50
R = 1000
MU_CHOICES = (1.0, 3.0, 9.0)
POLICIES = ("ccp", "tfrc_ccp", "best")

RTT_SWEEP = (0.0, 0.25, 1.0, 4.0)


def _base(churn: simulator.ChurnConfig, n: int = N) -> simulator.ScenarioConfig:
    return simulator.ScenarioConfig(
        N=n, scenario=1, mu_choices=MU_CHOICES, a_mode="inv_mu",
        rate_lo=1e6, rate_hi=2e6, churn=churn)


def iid_cfg(rtt_mean: float, n: int = N) -> simulator.ScenarioConfig:
    return _base(simulator.ChurnConfig(
        period=10.0, drop_prob=0.1, max_backoff=8.0,
        rtt_dist="fixed", rtt_mean=rtt_mean, rtt_het=0.5), n)


def burst_cfg(rtt_mean: float, n: int = N) -> simulator.ScenarioConfig:
    # fig_churn's burst regime (stationary loss ~17%) under jittered RTT.
    return _base(simulator.ChurnConfig(
        period=10.0, max_backoff=8.0,
        ge_p_bad=0.06, ge_p_good=0.25, ge_loss_good=0.0, ge_loss_bad=0.9,
        rtt_dist="lognormal", rtt_mean=rtt_mean, rtt_sigma=0.5), n)


def cell_cfg(rtt_mean: float, n: int = N) -> simulator.ScenarioConfig:
    return _base(simulator.ChurnConfig(
        period=5.0, max_backoff=8.0, drop_prob=0.05,
        p_cell=0.25, cell_frac=0.6,
        outage_dist="lognormal", outage_mean=4.0, outage_sigma=0.5,
        rtt_dist="cell", rtt_mean=rtt_mean,
        rtt_spike_prob=0.05, rtt_spike_scale=10.0), n)


REGIMES = {"iid": iid_cfg, "burst": burst_cfg, "cell": cell_cfg}


def _policy_stats(out) -> dict:
    """Per-policy stats with uncertified reps dropped and counted."""
    valid = certified(out, "fig_transport")
    return {
        **_stats(out.T.cpu().numpy()[valid]),
        "invalid": int((~valid).sum()),
        "efficiency": float(np.nanmean(out.efficiency.cpu().numpy()[valid])),
        "lost_frac": float(out.lost_frac.cpu().numpy()[valid].mean()),
        "max_backoff": float(out.max_backoff.cpu().numpy()[valid].max()),
        "M": out.M,
    }


def run(reps: int = 40, R: int = R, n_helpers: int = N, rtt_sweep=RTT_SWEEP,
        regimes=None, policies=POLICIES, *, device=None, seed: int = 0,
        out_dir=None) -> dict:
    regimes = dict(REGIMES if regimes is None else regimes)
    policies = tuple(policies)
    rtt_sweep = tuple(rtt_sweep)
    eng = engine.Engine(device=device)
    t0 = time.perf_counter()
    rows, summary, walls = [], {}, {}
    rtt_meta = {"sweep": list(rtt_sweep), "regimes": {}}
    for regime, mk_cfg in regimes.items():
        t_regime = time.perf_counter()
        regime_rows = []
        for rtt in rtt_sweep:
            cfg = mk_cfg(rtt, n_helpers)
            row = {"sweep": regime, "rtt_mean": rtt, "rtt_dist": cfg.churn.rtt_dist,
                   "R": R, "N": n_helpers}
            for p in policies:
                row[p] = _policy_stats(eng.run(cfg, p, reps, R, seed=seed))
            regime_rows.append(row)
        walls[regime] = time.perf_counter() - t_regime
        rows.extend(regime_rows)
        ch0 = mk_cfg(rtt_sweep[0], n_helpers).churn
        rtt_meta["regimes"][regime] = {f.name: getattr(ch0, f.name)
                                       for f in dataclasses.fields(ch0)
                                       if f.name.startswith("rtt_")}
        lo, hi = regime_rows[0], regime_rows[-1]
        for p in policies:
            # Delay inflation and efficiency retention across the sweep, each
            # policy against its own value at the sweep's first RTT.
            summary[f"{regime}_{p}_T_degradation"] = hi[p]["mean"] / lo[p]["mean"]
            summary[f"{regime}_{p}_eff_retention"] = hi[p]["efficiency"] / lo[p]["efficiency"]
        summary[f"{regime}_invalid_total"] = sum(
            r[p]["invalid"] for r in regime_rows for p in policies)
    if "burst" in regimes and {"ccp", "tfrc_ccp"} <= set(policies):
        # At the highest-RTT burst point: the event-rate response against the
        # reflexive backoff.
        hi = [r for r in rows if r["sweep"] == "burst"][-1]
        summary["burst_endpoint_tfrc_vs_ccp"] = hi["tfrc_ccp"]["mean"] / hi["ccp"]["mean"]
        summary["burst_endpoint_eff_tfrc_minus_ccp"] = (
            hi["tfrc_ccp"]["efficiency"] - hi["ccp"]["efficiency"])
    wall = time.perf_counter() - t0
    emit("fig_transport", rows, device=eng.device, seed=seed, wall_s=wall,
         policies=policy_meta(policies), out_dir=out_dir,
         derived=";".join(f"{k}={v:.3f}" for k, v in summary.items()),
         extra_meta={"rtt": rtt_meta})
    return {"rows": rows, "summary": summary, "policies": policies, "wall_s": wall,
            "regime_wall_s": walls}
