"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU: smoke steps, the coded-DP path, the config overrides, a run
saved mid-way and resumed, and the options that wait for other slices
refused.  ``--mesh D,1`` across ranks is in ``test_torch_ranks.py``."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import numpy as np
import pytest

from repro_torch.launch import train

SMOKE = ["--arch", "mistral-nemo-12b", "--smoke", "--device", "cpu", "--seq", "16",
         "--batch", "4"]


def test_three_smoke_steps_on_the_cpu(capsys):
    res = train.run(SMOKE + ["--steps", "3", "--n-micro", "2", "--log-every", "1"])
    hist = res["history"]
    assert [h["step"] for h in hist] == [0, 1, 2] and res["device"].type == "cpu"
    assert all(np.isfinite(h["loss"]) and h["ms"] > 0 and h["tokens_per_s"] > 0 for h in hist)
    sq = hist[0]["grad_leaf_sq"]
    assert np.all(np.isfinite(sq)) and np.all(sq > 0)
    assert res["loss"] == hist[-1]["loss"]
    assert res["sched_e_beta"].shape == (1,)
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "done: 3 steps" in out
    assert train.main(SMOKE + ["--steps", "1"]) == pytest.approx(hist[0]["loss"])


def test_coded_dp_runs_the_mesh_data_axis_as_workers(capsys):
    res = train.run(SMOKE + ["--steps", "2", "--coded-dp", "--mesh", "4,1", "--devices", "4"])
    assert len(res["history"]) == 2 and np.isfinite(res["loss"])
    assert res["sched_e_beta"].shape == (4,)
    assert "the port ignores it" in capsys.readouterr().err


def test_overrides_from_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_TRAIN_OVERRIDES", "n_layers=1,d_ff=64")
    res = train.run(SMOKE + ["--steps", "1"])
    assert (res["cfg"].n_layers, res["cfg"].d_ff) == (1, 64)


@pytest.mark.parametrize("what,match", [("production_mesh", "C6")])
def test_what_waits_for_other_slices_is_refused(what, match):
    """The reference's production mesh serves its dry run, which waits for
    slice C6; --mesh D,M with M > 1 runs (tests/test_torch_tp.py runs
    --mesh 2,2 with and without --coded-dp on 4 ranks)."""
    from repro_torch.launch import mesh

    with pytest.raises(NotImplementedError, match=match):
        mesh.make_production_mesh()


def test_ckpt_then_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    """--ckpt saves every --ckpt-every steps; --resume restores the latest
    and runs the rest, which repeat the uninterrupted run's steps exactly;
    --resume with no checkpoint yet starts from step 0."""
    args = SMOKE + ["--steps", "5", "--n-micro", "2", "--log-every", "1"]
    full = train.run(args)
    ck = ["--ckpt", str(tmp_path / "ck")]
    first = train.run(args + ck + ["--ckpt-every", "2", "--resume"])
    assert first["start"] == 0 and sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_000000002", "step_000000004"]
    assert first["ckpt"]["snapshot_s"] >= 0 and first["ckpt"]["write_s"] > 0
    resumed = train.run(args + ck + ["--resume"])
    assert resumed["start"] == 4 and [h["step"] for h in resumed["history"]] == [4]
    assert "resumed from step 4" in capsys.readouterr().out
    assert resumed["ckpt"]["restore_s"] > 0
    for key in ("loss", "grad_norm", "lr"):
        assert resumed["history"][0][key] == full["history"][4][key] == first["history"][4][key]
    assert np.all(resumed["history"][0]["grad_leaf_sq"] > 0)  # the first step run's


def test_mesh_data_axis_without_ranks_names_torchrun():
    """--mesh 2,1 trains across 2 ranks: without a process group (and
    without --coded-dp, which runs the workers in turn) it says how to
    start them."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        train.run(SMOKE + ["--steps", "1", "--mesh", "2,1"])
