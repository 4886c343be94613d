"""The port's churn figures on the CPU: ``fig_churn`` and ``fig_decode``
through ``python -m repro_torch.figures.run --smoke --device cpu`` (each
sweep's end points at a tenth of the width), their rows against the
reference figure scripts' row layout (``benchmarks/fig_churn.py``,
``benchmarks/fig_decode.py``, the committed artifacts' keys), and the
drop-and-count rule for uncertified reps.  The figures' numbers at full
size are checked on the card by ``chip_smoke.py``.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmarks import fig_churn as ref_churn
from benchmarks import fig_decode as ref_decode
from repro_torch.core import engine
from repro_torch.figures import common, fig_churn, fig_decode
from repro_torch.figures import run as figures_run

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _ref_rows(name):
    return json.loads((ROOT / "experiments" / "bench" / f"{name}.json").read_text())["data"]


def test_churn_figures_match_the_reference_scripts_setup():
    assert fig_churn.POLICIES == ref_churn.POLICIES
    assert (fig_churn.N, fig_churn.R, fig_churn.MU_CHOICES) == (
        ref_churn.N, ref_churn.R, ref_churn.MU_CHOICES)
    assert set(fig_churn.SWEEPS) == set(ref_churn.SWEEPS)
    for name, (axis, mk, axis_name) in fig_churn.SWEEPS.items():
        r_axis, r_mk, r_name = ref_churn.SWEEPS[name]
        assert axis == r_axis and axis_name == r_name
        for x in axis:
            port, ref = mk(x, 7), r_mk(x, 7)
            for f in ("N", "scenario", "mu_choices", "a_mode", "rate_lo", "rate_hi",
                      "overhead", "alpha"):
                assert getattr(port, f) == getattr(ref, f), (name, x, f)
            assert port.churn.static_key() == ref.churn.static_key()
            assert vars(port.churn) == vars(ref.churn)
    assert fig_decode.POLICIES == ref_decode.POLICIES
    assert (fig_decode.N, fig_decode.R, fig_decode.DROP_SWEEP) == (
        ref_decode.N, ref_decode.R, ref_decode.DROP_SWEEP)
    for p in fig_decode.DROP_SWEEP:
        port, ref = fig_decode.drop_cfg(p), ref_decode.drop_cfg(p)
        assert (port.churn is None) == (ref.churn is None)
        if port.churn is not None:
            assert vars(port.churn) == vars(ref.churn)


def test_churn_figures_smoke_lane(tmp_path):
    out = figures_run.main(["--smoke", "--device", "cpu", "--only", "fig_churn,fig_decode",
                            "--out", str(tmp_path)])
    assert set(out) == {"fig_churn", "fig_decode"}
    doc = json.loads((tmp_path / "fig_churn.json").read_text())
    assert doc["meta"]["device"] == {"type": "cpu"} and doc["meta"]["wall_s"] > 0
    assert tuple(doc["meta"]["policy"]) == fig_churn.POLICIES
    rows = doc["data"]
    assert [r["sweep"] for r in rows] == ["iid", "iid", "burst", "burst", "cell", "cell"]
    ref = _ref_rows("fig_churn")
    for r in rows:
        axis = next(k for k in ("drop_prob", "ge_p_bad", "p_cell") if k in r)
        match = next(x for x in ref if x["sweep"] == r["sweep"] and x[axis] == r[axis])
        assert set(r) == set(match), r["sweep"]  # the reference's row layout
        for p in fig_churn.POLICIES:
            assert set(r[p]) == set(match[p]) | {"M"}
            assert r[p]["invalid"] == 0 and np.isfinite(r[p]["mean"])
    summary = out["fig_churn"]["summary"]
    assert {"iid_adaptive_rate_vs_ccp", "burst_naive_vs_best_worst",
            "cell_invalid_total"} <= set(summary)
    assert set(out["fig_churn"]["sweep_wall_s"]) == {"iid", "burst", "cell"}

    doc = json.loads((tmp_path / "fig_decode.json").read_text())
    assert doc["meta"]["decoder"] == {"ccp": "counter", "rateless_ccp": "in_loop",
                                      "adaptive_rate_fb": "in_loop"}
    ref = _ref_rows("fig_decode")
    assert [r["drop_prob"] for r in doc["data"]] == [0.0, 0.2]
    for r in doc["data"]:
        assert set(r) == set(ref[0])
        assert r["compared_reps"] >= 1 and r["counter_gap"] > 0
        assert r["rateless_ccp"]["overhead"]["mean"] >= 0


def test_uncertified_reps_are_dropped_and_counted():
    """A rep that failed certification leaves the mean and counts as
    invalid; a run with no certified rep raises."""
    res = engine.Engine(device="cpu").run(fig_churn.burst_cfg(0.06, 6), "ccp", 4, 60)
    T = res.T.clone()
    res.valid = torch.tensor([True, False, True, False])
    res.T = torch.where(res.valid, T, torch.inf)
    stats = fig_churn._policy_stats(res)
    assert stats["invalid"] == 2
    assert stats["mean"] == pytest.approx(float(T[res.valid].double().mean()), rel=1e-6)
    res.valid = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="no certified rep"):
        fig_churn._policy_stats(res)
    with pytest.raises(RuntimeError, match="no certified rep"):
        common.certified(res, "x")
