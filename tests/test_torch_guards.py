"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package (nor ``msgpack``, ``zstandard`` or ``ml_dtypes``, which the card's
host need not have), and its entry points run on a CUDA card unless the
caller asks for the CPU."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import _device, interop, quickstart
from repro_torch.configs import get_config
from repro_torch.core import baselines, engine, simulator
from repro_torch.figures import run as figures_run
from repro_torch.launch import mesh
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.runtime import train_loop
from repro_torch.runtime.serve_loop import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED = r"""
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack", "zstandard", "ml_dtypes"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(mod.name)
from repro_torch import quickstart
res = quickstart.coded_offload(device="cpu")
assert max(res["rel_err"]) <= 1e-4, res
import torch
from repro_torch.core import coded_matmul as cm
from repro_torch.launch import mesh
plan = cm.plan_coded_matmul(rows=64, n_shards=4, overhead=0.5, bm=8)
a, x = torch.randn(64, 32), torch.randn(32, 16)
out = cm.run(plan, a, x, mesh=mesh.make_host_mesh(model=4, devices=["cpu"] * 4))
assert float((out - cm.run(plan, a, x)).abs().max()) < 1e-4
res = quickstart.rateless_vs_ccp(device="cpu", R=100, reps=2)
assert res["certified"], res
res = quickstart.ccp_vs_baselines(device="cpu", R=300, reps=2)
assert all(res["valid"].values()), res
from repro_torch.core import engine, simulator
one = engine.Engine(device="cpu").run(simulator.ScenarioConfig(N=6), "ccp", 3, 60)
two = engine.Engine(device="cpu", shard=True, devices=["cpu"] * 2).run(
    simulator.ScenarioConfig(N=6), "ccp", 3, 60)
assert torch.equal(one.T, two.T), (one.T, two.T)
churn = simulator.ScenarioConfig(N=8, churn=simulator.ChurnConfig(drop_prob=0.1, p_down=0.1))
res = engine.Engine(device="cpu").run(churn, "adaptive_rate_fb", 2, 60)
assert bool(res.valid.any()) and float(res.lost_frac.max()) > 0, res
transport = simulator.ScenarioConfig(N=8, churn=simulator.ChurnConfig(
    drop_prob=0.1, rtt_dist="lognormal", rtt_mean=1.0))
res = engine.Engine(device="cpu").run(transport, "tfrc_ccp", 2, 60)
assert bool(res.valid.all()) and float(res.extras["p_ev"].max()) > 0, res
from repro_torch.core import fleet
res = engine.Engine(device="cpu").run_fleet(simulator.ScenarioConfig(N=8), "ccp", 2, 60,
                                             fleet=fleet.FleetConfig(n_tasks=2, discipline="ps"))
assert res.T.shape == (2, 2) and bool(res.valid.all()), res
from repro_torch.launch import serve
out = serve.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu", "--requests", "3",
                  "--batch", "2", "--prompt-len", "6", "--new-tokens", "3", "--max-len", "16",
                  "--replicas", "2"])
assert len(out) == 3 and all(r.shape == (2, 3) for r in out), out
import numpy as np
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import ServeEngine
for arch in ("recurrentgemma-2b", "xlstm-350m", "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
             "whisper-large-v3"):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    frames = (np.random.default_rng(2).standard_normal((2, cfg.enc_frames, cfg.d_model))
              .astype(np.float32) * 0.02 if cfg.enc_dec else None)
    eng = ServeEngine(model, model.init(0, device="cpu"), max_len=16, device="cpu")
    out = eng.generate(tok, n_new=3, embeds=frames)
    assert out.shape == (2, 3) and out.min() >= 0 and out.max() < cfg.vocab, (arch, out)
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import make_coded_train_step, make_train_step
cfg = get_config("mistral-nemo-12b", smoke=True)
model = build_model(cfg, remat=True)
params = model.init(0, device="cpu")
tok = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 2, 8)).astype(np.int32)
step = make_train_step(model, adamw.AdamWConfig(), 2, pre_shaped=True, device="cpu")
params, state, m = step(params, adamw.init(params), {"tokens": tok, "labels": tok})
assert state.step == 1 and float(m["loss"]) > 0, m
step, code, (pats, ws) = make_coded_train_step(model, adamw.AdamWConfig(), 2, device="cpu")
params, state, m = step(params, adamw.init(params), {"tokens": tok, "labels": tok}, ws[0])
assert state.step == 1 and float(m["loss"]) > 0, m
import tempfile, torch
from repro_torch import checkpoint as ck
from repro_torch.checkpoint import checkpoint as ckm
assert ckm.zstandard is None and ckm.DEFAULT_CODEC == "zlib"
with tempfile.TemporaryDirectory() as d:
    tree = {"params": params, "opt": state}
    ck.save(d, 1, tree, metadata={"step": 1})
    r, meta = ck.restore(d, None, {"params": params, "opt": state})
    assert meta == {"step": 1} and r["opt"].step == 1, meta
    from repro_torch.launch import train
    args = ["--arch", "mistral-nemo-12b", "--smoke", "--device", "cpu", "--seq", "8",
            "--batch", "2", "--steps", "3", "--ckpt", d + "/run"]
    a = train.run(args + ["--ckpt-every", "2"])
    b = train.run(args + ["--resume"])
    assert b["start"] == 2 and b["loss"] == a["loss"], (a["loss"], b["loss"])
# the tensor-parallel step: --mesh 2,2 on 4 gloo ranks (spawned: fresh
# processes, whose imports are checked too)
from repro_torch.launch import mesh
outs = mesh.spawn_ranks(train.rank_main, 4, [
    "--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu", "--seq", "8", "--batch", "4",
    "--steps", "1", "--mesh", "2,2"], timeout_s=200)
assert all(o["ranks"] == 4 and o["losses"] == outs[0]["losses"] for o in outs), outs
assert not any(set(o["modules"]) & {"jax", "jaxlib", "repro", "msgpack", "ml_dtypes"}
               for o in outs), [o["modules"] for o in outs]
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack", "zstandard", "ml_dtypes")
               for m in sys.modules)
print("OK")
"""


def test_port_imports_no_jax_and_runs_without_it():
    env = _torch_env.env(PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_and_port_sources_name_no_jax():
    """No import of jax, of the reference package, of msgpack or of
    ml_dtypes in the port's sources or in chip_smoke.py (zstandard is an
    optional import of the checkpoint, as in the reference)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = {f.relative_to(ROOT / "src" / "repro_torch").as_posix() for f in files[:-1]}
    assert {"optim/adamw.py", "data/pipeline.py", "runtime/train_loop.py",
            "core/gradient_coding.py", "launch/train.py",
            "kernels/flash_attention/autograd.py", "models/rglru.py", "models/xlstm.py",
            "models/moe.py", "models/encdec.py", "checkpoint/checkpoint.py",
            "checkpoint/_msgpack.py", "utils/roofline.py", "utils/trace.py",
            "launch/mesh.py", "parallel/__init__.py", "parallel/sharding.py",
            "parallel/collectives.py", "parallel/tensor.py", "models/moe_a2a.py",
            "runtime/elastic.py", "interop.py", "kernels/flash_attention/ops.py"} <= names
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes"), (f, line)


def test_default_device_is_cuda_and_entry_points_refuse_without_a_card():
    assert _device.DEFAULT_DEVICE == "cuda"
    assert _device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would use it")
    cfg = simulator.ScenarioConfig(N=4)
    z = np.zeros((1, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.Engine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.coded_offload()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.ccp_vs_best(reps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.rateless_vs_ccp(reps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.ccp_vs_baselines(reps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.run_hcmm(cfg, 20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        figures_run.main(["--smoke", "--only", "fig5"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        figures_run.main(["--smoke", "--only", "fig_churn,fig_decode"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        figures_run.main(["--smoke", "--only", "fig_transport"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        figures_run.main(["--smoke", "--only", "fig_fleet"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.Engine().run_fleet(cfg, "ccp", 2, 20)
    z4 = np.zeros((1, 1, 4, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.fleet_tables_from_numpy(z, z, z, z4, z4, z4, z4, z[:, :1], z[:, None] > 0,
                                        z[:, :1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.dynamics_from_numpy({"drop": np.zeros((1, 4, 2), bool)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launch.main(["--arch", "phi4-mini-3.8b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--arch", "mistral-nemo-12b", "--smoke", "--steps", "1"])
    model = build_model(get_config("phi4-mini-3.8b", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop.make_train_step(model, adamw.AdamWConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop.make_coded_train_step(model, adamw.AdamWConfig(), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.data_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.Engine(shard=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init_ranks(0, 1, store_path="unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop.make_eval_step(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.adamw_state_from_numpy(adamw.init({}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.lm_params_from_numpy(model.cfg, {"blocks": {}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.tables_from_numpy(z, z, z, z[..., None], z[..., None],
                                  z[..., None], z[..., None])
    assert engine.Engine(device="cpu").run(cfg, "best", 2, 20).T.shape == (2,)


def test_tables_from_numpy_casts_to_float32():
    z64 = np.ones((2, 3), np.float64)
    t = interop.tables_from_numpy(z64, z64, z64, z64[..., None], z64[..., None],
                                  z64[..., None], z64[..., None], device="cpu")
    assert all(getattr(t, f).dtype == torch.float32
               for f in ("mu", "a", "rate", "beta", "d_up", "d_ack", "d_down"))
    with pytest.raises(ValueError, match="packet tables"):
        interop.tables_from_numpy(z64, z64, z64, z64, z64, z64, z64, device="cpu")
