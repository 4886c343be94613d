"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points run on a CUDA card unless the caller asks
for the CPU."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import _device, interop, quickstart
from repro_torch.core import engine, simulator

ROOT = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED = r"""
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(mod.name)
from repro_torch import quickstart
res = quickstart.coded_offload(device="cpu")
assert max(res["rel_err"]) <= 1e-4, res
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
print("OK")
"""


def test_port_imports_no_jax_and_runs_without_it():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_and_port_sources_name_no_jax():
    """No import of jax or of the reference package in the port's sources
    or in chip_smoke.py."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, line)


def test_default_device_is_cuda_and_entry_points_refuse_without_a_card():
    assert _device.DEFAULT_DEVICE == "cuda"
    assert _device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would use it")
    cfg = simulator.ScenarioConfig(N=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.Engine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.coded_offload()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.ccp_vs_best(reps=2)
    z = np.zeros((1, 4), np.float32)
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
