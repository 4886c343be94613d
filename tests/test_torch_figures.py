"""The port's paper-figure scripts and the quickstart's baselines on the CPU.

``python -m repro_torch.figures.run --smoke --device cpu`` runs Figs. 3-5 and
the efficiency table at a tiny scale into a temporary directory (the
counterpart of ``tests/test_bench_smoke.py``'s lane): every policy column,
no uncertified rep, and the artifact's meta.  The figures' own numbers are
checked on the card at full size by ``chip_smoke.py``.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import quickstart
from repro_torch.configs.ccp_paper import FIG3
from repro_torch.core import engine, theory
from repro_torch.figures import common, fig3, fig4, fig5
from repro_torch.figures import run as figures_run

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_figures_smoke_lane(tmp_path):
    env = _torch_env.env(PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.figures.run", "--smoke", "--device", "cpu",
         "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("fig3", "fig4", "fig5", "efficiency"):
        assert any(line.startswith(f"{name},-,") for line in proc.stdout.splitlines()), name
        doc = json.loads((tmp_path / f"{name}.json").read_text())
        meta = doc["meta"]
        assert meta["key_schedule"] == common.KEY_SCHEDULE and meta["seed"] == 0
        assert meta["device"] == {"type": "cpu"} and meta["wall_s"] > 0
        assert set(meta["decoder"].values()) == {"counter"}
        rows = doc["data"]
        if name == "efficiency":
            assert [r["scenario"] for r in rows] == [1, 2]
            for r in rows:
                assert r["invalid"] == 0 and 0.9 < r["measured"] <= 1.0
                assert 0.9 < r["theory_eq12"] <= 1.0
            continue
        policies = {"fig3": fig3.POLICIES, "fig4": fig4.POLICIES, "fig5": fig5.POLICIES}[name]
        assert tuple(meta["policy"]) == policies
        assert len(rows) == 2
        for r in rows:
            for p in policies:
                assert r[p]["invalid"] == 0 and np.isfinite(r[p]["mean"]), (name, p, r)
        if name == "fig3":
            assert all(r["optimum"]["mean"] > 0 for r in rows)
        if name == "fig5":
            assert [r["R"] for r in rows] == [200, 400]
            assert all("gap_naive" in r and "gap_best" in r for r in rows)


def test_figure_runner_refuses_unknown_names(tmp_path):
    with pytest.raises(ValueError, match="known policies"):
        figures_run.main(["--smoke", "--device", "cpu", "--policies", "ccp,nope",
                          "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="unknown figures"):
        figures_run.main(["--smoke", "--device", "cpu", "--only", "fig9",
                          "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_figure_policy_subset_and_reps(tmp_path):
    out = figures_run.main(["--smoke", "--device", "cpu", "--only", "fig5", "--reps", "3",
                            "--policies", "ccp,best", "--out", str(tmp_path)])
    assert set(out) == {"fig5"}
    doc = json.loads((tmp_path / "fig5.json").read_text())
    assert set(doc["meta"]["policy"]) == {"ccp", "best"}
    assert all("gap_naive" not in r and "naive" not in r for r in doc["data"])


def test_optimum_column_is_over_the_ccp_runs_own_draws():
    """Fig. 3's Optimum Analysis column is eq. (27) over the helpers the
    CCP run of the same row drew."""
    eng, cfg, R, reps = engine.Engine(device="cpu"), FIG3[2], 300, 3
    stats, res = common.mc_policy(eng, cfg, R, reps, "ccp", seed=4)
    mu, a = res.mu.numpy(), res.a.numpy()
    t = [theory.t_opt_model1(R, cfg.K(R), a[r], mu[r]) for r in range(reps)]
    assert common.optimum(eng, cfg, R, reps, seed=4) == {
        "mean": float(np.mean(t)), "std": float(np.std(t))}
    assert stats["invalid"] == 0
    assert stats["mean"] == pytest.approx(float(res.T.double().mean()), rel=1e-6)


def test_improvement_summary_averages_over_the_sweep():
    rows = [{"ccp": {"mean": 8.0}, "best": {"mean": 8.0}, "hcmm": {"mean": 10.0},
             "uncoded_mean": {"mean": 16.0}, "uncoded_mu": {"mean": 20.0},
             "optimum": {"mean": 4.0}},
            {"ccp": {"mean": 9.0}, "best": {"mean": 6.0}, "hcmm": {"mean": 18.0},
             "uncoded_mean": {"mean": 12.0}, "uncoded_mu": {"mean": 9.0},
             "optimum": {"mean": 9.0}}]
    s = common.improvement_summary(2, rows, fig3.POLICIES)
    assert s == pytest.approx({"sc2_vs_hcmm": (0.2 + 0.5) / 2,
                               "sc2_vs_uncoded": (0.5 + 0.0) / 2,
                               "sc2_vs_best": (0.0 + 0.5) / 2,
                               "sc2_vs_optimum": (1.0 + 0.0) / 2})
    assert common.improvement_summary(1, rows, ("ccp", "hcmm")) == pytest.approx(
        {"sc1_vs_hcmm": 0.35, "sc1_vs_optimum": 0.5})


def test_ccp_vs_baselines_on_the_cpu():
    """The quickstart's first part: five policies on one seed (the same
    helper draws), CCP ahead of every baseline, near eq. (27)."""
    out = quickstart.ccp_vs_baselines(device="cpu", R=1000, reps=6, seed=1)
    assert set(out["valid"]) == set(quickstart.POLICIES) == set(out["M"])
    assert all(out["valid"].values())
    t_ccp = out["T_ccp"]
    assert all(t_ccp < out[f"T_{p}"] for p in ("uncoded_mean", "uncoded_mu", "hcmm"))
    assert t_ccp <= 1.25 * out["T_opt"]
    assert out["vs_hcmm"] == pytest.approx(1 - t_ccp / out["T_hcmm"])
    assert out["vs_uncoded"] == pytest.approx(
        1 - t_ccp / min(out["T_uncoded_mean"], out["T_uncoded_mu"]))
    assert out["efficiency"] > 0.99 and out["wall_s"] > 0
    # every policy's run started from the same helper draw
    runs = [engine.Engine(device="cpu").run(FIG3[1], p, 6, 1000, seed=1)
            for p in ("ccp", "hcmm")]
    assert torch.equal(runs[0].mu, runs[1].mu)
