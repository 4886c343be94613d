"""Shared helpers of the paper-figure scripts.

Every ``Engine.run`` of a figure draws from a fresh
``torch.Generator(device).manual_seed(seed)`` with the figure's one seed,
and the helper draw comes first, so every policy and every R of a figure
sees the same helpers rep for rep (the role of the reference's
``simulator.batch_keys(reps, seed0)``).  The draws are not the reference's
bits: figures agree with its artifacts in distribution, not per rep.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import engine, policies as policy_registry, simulator, theory

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "figures"
KEY_SCHEDULE = "torch.Generator(device).manual_seed(seed), one per Engine.run"


def _stats(a: np.ndarray) -> Dict[str, float]:
    return {"mean": float(a.mean()), "std": float(a.std()),
            "sem": float(a.std() / np.sqrt(len(a)))}


def certified(out, label: str) -> np.ndarray:
    """The certification mask of an ``Engine.run`` result, the one shared
    drop-the-invalid-reps gate: raises when *no* rep is certified, otherwise
    returns the boolean mask the caller must apply before aggregating
    (counting ``~mask`` as invalid)."""
    valid = out["valid"].cpu().numpy()
    if not valid.any():
        raise RuntimeError(f"{label}: no certified rep at horizon cap (M={out['M']})")
    return valid


def mc_policy(eng: engine.Engine, cfg, R: int, reps: int, policy: str,
              seed: int = 0):
    """Monte-Carlo over ``reps`` reps of ``policy`` through ``eng``: the
    mean/std/sem of T over the certified reps and the count of the others
    (``invalid``), and the run itself."""
    out = eng.run(cfg, policy, reps, R, seed=seed)
    valid = certified(out, f"mc_policy policy={policy!r} R={R}")
    stats = _stats(out.T.cpu().numpy()[valid])
    stats["invalid"] = int((~valid).sum())
    return stats, out


def optimum(eng: engine.Engine, cfg, R: int, reps: int, seed: int = 0) -> Dict[str, float]:
    """Eq. (27)'s optimum over the helper draw that every run of the row
    starts from, the CCP run's own.  (The reference draws this column with
    ``jax.random.PRNGKey(r)``, a key schedule apart from its policies'.)"""
    mu, a, _rate = simulator.draw_helpers(engine._generator(seed, eng.device), cfg, reps)
    mu, a = mu.cpu().numpy(), a.cpu().numpy()
    t = [theory.t_opt_model1(R, cfg.K(R), a[r], mu[r]) for r in range(reps)]
    return {"mean": float(np.mean(t)), "std": float(np.std(t))}


def improvement_summary(sc: int, rows: List[dict], policies) -> Dict[str, float]:
    """The paper's "in average, X% improvement" over a scenario's R sweep."""
    avg = lambda f: float(np.mean([f(r) for r in rows]))  # noqa: E731
    has = lambda *ps: all(p in policies for p in ps)  # noqa: E731
    out = {}
    if has("ccp", "hcmm"):
        out[f"sc{sc}_vs_hcmm"] = avg(lambda r: 1 - r["ccp"]["mean"] / r["hcmm"]["mean"])
    if has("ccp", "uncoded_mean", "uncoded_mu"):
        out[f"sc{sc}_vs_uncoded"] = avg(lambda r: 1 - r["ccp"]["mean"] / min(
            r["uncoded_mean"]["mean"], r["uncoded_mu"]["mean"]))
    if has("ccp", "best"):
        out[f"sc{sc}_vs_best"] = avg(lambda r: r["ccp"]["mean"] / r["best"]["mean"] - 1)
    if has("ccp") and "optimum" in rows[0]:
        out[f"sc{sc}_vs_optimum"] = avg(lambda r: r["ccp"]["mean"] / r["optimum"]["mean"] - 1)
    return out


def delay_sweep(name: str, cfgs: Dict[int, object], reps: int, r_sweep, policies, *,
                device, seed: int, out_dir, with_optimum: bool) -> dict:
    """Figs. 3 and 4: mean T of every policy at every R of both scenarios
    (``cfgs`` maps scenario -> config), with eq. (27)'s column when
    ``with_optimum``, and the improvement summary of each scenario."""
    policies = tuple(policies)
    eng = engine.Engine(device=device)
    t0 = time.perf_counter()
    rows, summary = [], {}
    for sc, cfg in cfgs.items():
        for R in r_sweep:
            row = {"scenario": sc, "R": R}
            for p in policies:
                row[p], _ = mc_policy(eng, cfg, R, reps, p, seed)
            if with_optimum:
                row["optimum"] = optimum(eng, cfg, R, reps, seed)
            rows.append(row)
        summary.update(improvement_summary(sc, [r for r in rows if r["scenario"] == sc],
                                           policies))
    wall = time.perf_counter() - t0
    emit(name, rows, device=eng.device, seed=seed, wall_s=wall,
         policies=policy_meta(policies), out_dir=out_dir,
         derived=";".join(f"{k}={v:.3f}" for k, v in summary.items()))
    return {"rows": rows, "summary": summary, "wall_s": wall}


def policy_meta(names) -> Dict[str, int]:
    """Registry name -> version for every policy a figure swept."""
    return {n: policy_registry.get(n).version for n in names}


def device_meta(device: torch.device) -> Dict[str, object]:
    """The device a figure ran on; on CUDA the card's name and power limit
    as ``nvidia-smi`` reports them."""
    if device.type != "cuda":
        return {"type": device.type}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()
    return {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": smi[device.index or 0].strip()}


def emit(name: str, rows: List[dict], *, device: torch.device, seed: int,
         wall_s: float, policies: Optional[Dict[str, int]] = None,
         derived: str = "", out_dir: Optional[Path] = None,
         extra_meta: Optional[Dict[str, object]] = None) -> Path:
    """Write ``{"meta", "data"}`` JSON to ``out_dir/<name>.json`` and print
    the ``name,-,derived`` line.  ``meta`` holds the key schedule and seed,
    the policy versions and each policy's completion semantics
    (``"in_loop"`` decoding or ``"counter"``), the device and the wall
    time (seconds on the host's clock), and ``extra_meta``'s keys (e.g.
    fig_transport's ``rtt``, fig_fleet's ``discipline``)."""
    out_dir = Path(out_dir) if out_dir is not None else OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = {"key_schedule": KEY_SCHEDULE, "seed": seed,
            "device": device_meta(device), "wall_s": wall_s}
    if policies:
        meta["policy"] = dict(policies)
        meta["decoder"] = {n: ("in_loop" if policy_registry.get(n).uses_decoder
                               else "counter") for n in policies}
    if extra_meta:
        meta.update(extra_meta)
    path = out_dir / f"{name}.json"
    path.write_text(json.dumps({"meta": meta, "data": rows}, indent=1))
    print(f"{name},-,{derived}", flush=True)
    return path

