"""The port's transport and fleet figures on the CPU: ``fig_transport`` and
``fig_fleet`` through ``python -m repro_torch.figures.run --smoke --device
cpu`` (the RTT sweep's end points, tasks 1 and 4, at a tenth of the width),
their setup against the reference figure scripts
(``benchmarks/fig_transport.py``, ``benchmarks/fig_fleet.py``), their rows
against the committed artifacts' layout, and the drop-and-count rule.  The
figures at full size are checked on the card by ``chip_smoke.py``.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmarks import fig_fleet as ref_fleet
from benchmarks import fig_transport as ref_transport
from repro_torch.core import engine
from repro_torch.figures import fig_fleet, fig_transport
from repro_torch.figures import run as figures_run

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _ref(name):
    return json.loads((ROOT / "experiments" / "bench" / f"{name}.json").read_text())


def test_figures_match_the_reference_scripts_setup():
    assert (fig_transport.N, fig_transport.R, fig_transport.MU_CHOICES, fig_transport.POLICIES,
            fig_transport.RTT_SWEEP) == (ref_transport.N, ref_transport.R,
                                         ref_transport.MU_CHOICES, ref_transport.POLICIES,
                                         ref_transport.RTT_SWEEP)
    assert set(fig_transport.REGIMES) == set(ref_transport.REGIMES)
    for name, mk in fig_transport.REGIMES.items():
        for rtt in fig_transport.RTT_SWEEP:
            port, ref = mk(rtt, 7), ref_transport.REGIMES[name](rtt, 7)
            for f in ("N", "scenario", "mu_choices", "a_mode", "rate_lo", "rate_hi"):
                assert getattr(port, f) == getattr(ref, f), (name, f)
            assert dataclasses.asdict(port.churn) == dataclasses.asdict(ref.churn)
    assert (fig_fleet.N, fig_fleet.R, fig_fleet.TASK_SWEEP, fig_fleet.HELPERS_PER_TASK,
            fig_fleet.POLICIES, fig_fleet.DISCIPLINE) == (
        ref_fleet.N, ref_fleet.R, ref_fleet.TASK_SWEEP, ref_fleet.HELPERS_PER_TASK,
        ref_fleet.POLICIES, ref_fleet.DISCIPLINE)


def test_transport_and_fleet_smoke_lane(tmp_path):
    out = figures_run.main(["--smoke", "--device", "cpu", "--only", "fig_transport,fig_fleet",
                            "--out", str(tmp_path)])
    assert set(out) == {"fig_transport", "fig_fleet"}
    doc = json.loads((tmp_path / "fig_transport.json").read_text())
    ref = _ref("fig_transport")
    assert doc["meta"]["device"] == {"type": "cpu"} and doc["meta"]["wall_s"] > 0
    assert doc["meta"]["rtt"]["sweep"] == [0.0, 4.0]
    assert doc["meta"]["rtt"]["regimes"] == ref["meta"]["rtt"]["regimes"]
    rows = doc["data"]
    assert [(r["sweep"], r["rtt_mean"]) for r in rows] == [
        (s, x) for s in ("iid", "burst", "cell") for x in (0.0, 4.0)]
    for r in rows:
        match = next(x for x in ref["data"] if (x["sweep"], x["rtt_mean"]) == (r["sweep"],
                                                                               r["rtt_mean"]))
        assert set(r) == set(match)
        for p in fig_transport.POLICIES:
            assert set(r[p]) == set(match[p]) | {"M"} and r[p]["invalid"] == 0
    for s in ("iid", "burst", "cell"):  # best reads no feedback: flat across RTT
        lo, hi = (r["best"]["mean"] for r in rows if r["sweep"] == s)
        assert lo == hi
        assert out["fig_transport"]["summary"][f"{s}_ccp_T_degradation"] > 1.5
    assert "burst_endpoint_tfrc_vs_ccp" in out["fig_transport"]["summary"]

    doc = json.loads((tmp_path / "fig_fleet.json").read_text())
    ref = _ref("fig_fleet")
    assert doc["meta"]["discipline"] == ref["meta"]["discipline"] == "fifo"
    assert [r["n_tasks"] for r in doc["data"]] == [1, 4]
    for r in doc["data"]:
        assert set(r) == set(ref["data"][0])
        for p in fig_fleet.POLICIES:
            assert set(r[p]) == set(ref["data"][0][p]) | {"M"} and r[p]["invalid"] == 0
            assert r[p]["p99"] >= r[p]["p50"] > 0
    assert set(out["fig_fleet"]["knee"]) == set(fig_fleet.POLICIES)


def test_uncertified_reps_are_dropped_and_counted():
    res = engine.Engine(device="cpu").run(fig_transport.burst_cfg(1.0, 6), "ccp", 4, 60)
    T = res.T.clone()
    res.valid = torch.tensor([True, False, True, False])
    stats = fig_transport._policy_stats(res)
    assert stats["invalid"] == 2
    assert stats["mean"] == pytest.approx(float(T[res.valid].double().mean()), rel=1e-6)
    res.valid = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="no certified rep"):
        fig_transport._policy_stats(res)
    fl = engine.Engine(device="cpu").run_fleet(fig_fleet.simulator.ScenarioConfig(N=6), "ccp",
                                               3, 40)
    fl.valid[0, 0] = False
    s = fl.summary()
    assert s["invalid"] == 1
    assert s["p50"] == pytest.approx(float(np.percentile(fl.sojourn[1:, 0].numpy(), 50)))
