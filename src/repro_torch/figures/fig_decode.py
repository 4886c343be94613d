"""Beyond-paper figure: measured LT decode overhead and honest completion.
T is simulated seconds.

The paper's O(R) Raptor argument treats the fountain code as an ideal MDS
abstraction: any R+K packets complete the task.  With the decoder in the
loop the port measures what the code actually does:

  * ``rateless_ccp`` completes when the incremental peeling decode
    succeeds, so its per-rep overhead ``r_n.sum() - R`` is the *measured*
    LT overhead, swept against the i.i.d. loss rate;
  * ``rateless_ccp / ccp`` is the honesty gap of the packet counter;
  * ``adaptive_rate_fb`` shows what decoder feedback buys (adapted send
    overhead plus stop-on-decode);
  * every row carries the offline anchors: an arrival-order Monte-Carlo
    of the same parity pool (:func:`repro_torch.core.decode
    .offline_overhead_samples`) and the robust-soliton failure statistics
    (:func:`repro_torch.core.fountain.decode_failure_prob`).

Helpers are homogeneous (mu = 2.0) so the overhead reflects the loss
process, not straggler reordering.  Uncertified reps are dropped and
counted, never averaged.  Port of ``benchmarks/fig_decode.py``.
"""

from __future__ import annotations

import time

import numpy as np

from ..core import decode, engine, fountain, simulator
from .common import _stats, certified, emit, policy_meta

N = 20
R = 400
DROP_SWEEP = (0.0, 0.1, 0.2, 0.3)
POLICIES = ("ccp", "rateless_ccp", "adaptive_rate_fb")


def drop_cfg(drop_prob: float, n: int = N) -> simulator.ScenarioConfig:
    churn = (simulator.ChurnConfig(drop_prob=drop_prob, max_backoff=8.0)
             if drop_prob > 0 else None)
    return simulator.ScenarioConfig(N=n, scenario=1, mu_choices=(2.0,), churn=churn)


def _overhead_stats(out, R: int, valid) -> dict:
    ov = (out.r_n.cpu().numpy().sum(axis=1) - R)[valid]
    return {
        **_stats(ov.astype(np.float64)),
        "p95": float(np.percentile(ov, 95)),
        "frac_mean": float(ov.mean() / R),
    }


def run(reps: int = 40, sweep=DROP_SWEEP, R: int = R, n_helpers: int = N,
        offline_trials: int = 8, *, device=None, seed: int = 0, out_dir=None) -> dict:
    eng = engine.Engine(device=device)
    t0 = time.perf_counter()
    code = decode.make_decoder_code(R)
    rows, summary = [], {}
    for p in sweep:
        cfg = drop_cfg(p, n_helpers)
        row = {"drop_prob": p, "R": R, "N": n_helpers}
        results = {}
        for pol in POLICIES:
            out = eng.run(cfg, pol, reps, R, seed=seed)
            valid = certified(out, f"fig_decode policy={pol!r} p={p}")
            results[pol] = (out, valid)
            row[pol] = {**_stats(out.T.cpu().numpy()[valid]),
                        "invalid": int((~valid).sum()), "M": out.M}
            if pol != "ccp":
                row[pol]["overhead"] = _overhead_stats(out, R, valid)
        # Cross-policy ratios over the reps every policy certified: a ratio
        # of means over different rep subsets would compare different
        # Monte-Carlo ensembles.
        both = np.logical_and.reduce([v for _, v in results.values()])
        if not both.any():
            raise RuntimeError(f"fig_decode p={p}: no rep certified for every policy")
        mean_on = {pol: float(out.T.cpu().numpy()[both].mean())
                   for pol, (out, _v) in results.items()}
        row["compared_reps"] = int(both.sum())
        row["counter_gap"] = mean_on["rateless_ccp"] / mean_on["ccp"]
        row["feedback_gain"] = mean_on["adaptive_rate_fb"] / mean_on["rateless_ccp"]
        # Offline anchors: the same pool code, arrival-order MC, and the
        # generic robust-soliton failure probability at the matched loss.
        off = decode.offline_overhead_samples(R, code, p, trials=offline_trials, seed=7)
        ok = off[off >= 0]
        row["offline"] = {
            "overhead_mean": float(ok.mean()) if ok.size else None,
            "overhead_frac": float(ok.mean() / R) if ok.size else None,
            "pool_undecodable": int((off < 0).sum()),
            "trials": int(off.size),
        }
        K = R // 2
        row["soliton_failure"] = fountain.decode_failure_prob(
            R, K, int(np.ceil(p * (R + K))), trials=10, seed=0)
        rows.append(row)
    for p, row in zip(sweep, rows):
        summary[f"gap_p{p}"] = row["counter_gap"]
        summary[f"ov_frac_p{p}"] = row["rateless_ccp"]["overhead"]["frac_mean"]
        summary[f"fb_gain_p{p}"] = row["feedback_gain"]
    wall = time.perf_counter() - t0
    emit("fig_decode", rows, device=eng.device, seed=seed, wall_s=wall,
         policies=policy_meta(POLICIES), out_dir=out_dir,
         derived=";".join(f"{k}={v:.3f}" for k, v in summary.items()))
    return {"rows": rows, "summary": summary, "wall_s": wall}
