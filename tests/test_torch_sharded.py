"""The port's paths over a grid of devices, in one process (slice C5a):
``parallel.sharding``'s data mesh and batch spec, ``core.coded_matmul.run``
over a mesh (one call of the fused product a shard), and
``Engine(shard=True)`` / ``run_fleet(shard=True)``, which split the reps
over the devices.  On the CPU the "devices" are the CPU named several
times, as the reference's tests force 8 XLA host devices.  Mirrors
``tests/test_sharding.py:76,105``, the coded-matmul part of
``tests/test_multidevice.py`` and the shard cases of
``tests/test_simulator_dynamics.py`` and ``tests/test_fleet.py`` (their
configs, 11 reps: not a multiple of the devices).  The reference's
outputs come from its single-device functions."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_matmul as cm_jax
from repro.parallel import sharding as shd_jax
from repro_torch.core import coded_matmul as cm
from repro_torch.core import engine, fleet, simulator
from repro_torch.launch import mesh
from repro_torch.parallel import sharding as shd

CPU8 = ["cpu"] * 8


class FakeMesh:
    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


@pytest.mark.parametrize("shape,names", [((2, 16, 16), ("pod", "data", "model")),
                                         ((16, 16), ("data", "model")), ((8,), ("data",)),
                                         ((1, 8), ("data", "model"))])
def test_batch_spec_matches_the_reference(shape, names):
    """Divisibility over ('pod', 'data') and the bare-name normalisation, for
    every batch from 1 to 64 and 0-2 replicated dims."""
    m = FakeMesh(shape, names)
    for batch in range(1, 65):
        for extra in range(3):
            assert shd.batch_spec(m, batch, extra) == tuple(shd_jax.batch_spec(m, batch, extra))
    if names[0] == "pod":  # tests/test_sharding.py:76
        assert shd.batch_spec(m, 256)[0] == ("pod", "data")
        assert shd.batch_spec(m, 16)[0] == "data"
        assert shd.batch_spec(m, 1)[0] is None


def test_data_mesh_over_the_devices_given():
    """tests/test_sharding.py:105 on the devices given (the default, every
    local card, raises here: no card)."""
    m = shd.data_mesh(CPU8)
    assert m.axis_names == ("data",) and m.devices.shape == (8,)
    sub = shd.data_mesh(CPU8[:1])
    assert sub.devices.shape == (1,)
    assert shd.batch_spec(sub, 4, extra_dims=1) == ("data", None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            shd.data_mesh()


def test_host_mesh_grid_and_refusals():
    m = mesh.make_host_mesh(data=2, model=4, devices=CPU8)
    assert m.shape == {"data": 2, "model": 4} and len(m.axis_devices("model")) == 4
    assert m.axis_devices("data") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs 8 devices"):
        mesh.make_host_mesh(data=2, model=4, devices=CPU8[:3])
    with pytest.raises(NotImplementedError, match="C6"):
        mesh.make_production_mesh()


# -------------------------------------------------- the sharded coded matmul

@pytest.fixture(scope="module")
def plan_inputs():
    """tests/test_multidevice.py's plan: rows 256, 8 shards, overhead 0.5,
    bm 16; A (256, 64), X (64, 32)."""
    plan = cm.plan_coded_matmul(rows=256, n_shards=8, overhead=0.5, bm=16)
    rng = np.random.default_rng(2)
    a = rng.standard_normal((256, 64)).astype(np.float32)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    return plan, a, x


@pytest.mark.parametrize("model", [8, 4, 1])
def test_sharded_run_matches_unsharded_and_reference(plan_inputs, model, monkeypatch):
    """One call of the fused product a device along the axis (8 shards on 8
    devices: one a shard), the output shard-major as the unsharded run's and
    the reference's (< 1e-4), and the collector recovers y = A x without
    shard 1 (< 5e-3)."""
    plan, a, x = plan_inputs
    calls = []
    real = cm.coded_matmul_op

    def counting(a_, *args, **kw):
        calls.append(a_.device)
        return real(a_, *args, **kw)

    monkeypatch.setattr(cm, "coded_matmul_op", counting)
    grid = mesh.make_host_mesh(data=8 // model, model=model, devices=CPU8)
    at, xt = torch.as_tensor(a), torch.as_tensor(x)
    out = cm.run(plan, at, xt, mesh=grid, axis="model")
    assert len(calls) == model
    plan_j = cm_jax.plan_coded_matmul(rows=256, n_shards=8, overhead=0.5, bm=16)
    ref = np.asarray(cm_jax.run(plan_j, jnp.asarray(a), jnp.asarray(x)))
    one = cm.run(plan, at, xt)
    assert out.shape == one.shape == ref.shape
    assert float((out - one).abs().max()) < 1e-4
    assert float(np.abs(out.numpy() - ref).max()) < 1e-4
    y = cm.recover(plan, out, survivors=np.array([0, 2, 3, 4, 5, 6, 7]))
    assert float(np.abs(y.numpy() - a @ x).max()) < 5e-3


def test_sharded_run_refuses_an_uneven_split(plan_inputs):
    plan, a, x = plan_inputs
    grid = mesh.make_host_mesh(model=5, devices=CPU8[:5])  # 24 coded blocks
    with pytest.raises(ValueError, match="do not split"):
        cm.run(plan, torch.as_tensor(a), torch.as_tensor(x), mesh=grid)


# ------------------------------------------------------- the sharded engine

def _equal(a, b) -> bool:
    """Bitwise, NaN equal to NaN (efficiency is NaN for a helper that
    computed nothing within T)."""
    for k in a.keys():
        x, y = a[k], b[k]
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
        elif x.shape != y.shape or x.dtype != y.dtype:
            return False
        elif x.dtype.is_floating_point:
            if not (torch.equal(x.isnan(), y.isnan())
                    and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))):
                return False
        elif not torch.equal(x, y):
            return False
    return True


# tests/test_simulator_dynamics.py:393's config: churn with GE burst loss.
DYN_CFG = simulator.ScenarioConfig(
    N=8, scenario=1,
    churn=simulator.ChurnConfig(p_down=0.05, drop_prob=0.1, ge_p_bad=0.02, ge_p_good=0.2,
                                ge_loss_bad=0.5))


@pytest.mark.parametrize("mode", ["ccp", "naive_oracle", "rateless_ccp"])
def test_sharded_engine_is_bitwise_the_unsharded_run(mode):
    """11 reps over 8 devices (padded, then dropped), the decoder-in-the-loop
    policy included; ccp also over 3 devices given to ``run``."""
    eng = engine.Engine(device="cpu")
    a = eng.run(DYN_CFG, mode, 11, 120, seed=1)
    b = engine.Engine(device="cpu", shard=True, devices=CPU8).run(DYN_CFG, mode, 11, 120, seed=1)
    assert b.M == a.M and _equal(a, b)
    if mode == "ccp":
        c = eng.run(DYN_CFG, mode, 11, 120, seed=1, shard=True, devices=CPU8[:3])
        assert _equal(a, c)


def test_sharded_fleet_is_bitwise_the_unsharded_run():
    """tests/test_fleet.py:436's config: 6 helpers, 3 striped tenants of 3
    helpers, churn with GE loss and a fixed RTT, 11 reps over 8 devices."""
    ch = simulator.ChurnConfig(period=5.0, p_down=0.15, p_slow=0.25, drop_prob=0.05,
                               ge_p_bad=0.03, ge_p_good=0.25, ge_loss_bad=0.5,
                               rtt_dist="fixed", rtt_mean=0.5, max_backoff=8.0)
    cfg = simulator.ScenarioConfig(N=6, scenario=1, churn=ch)
    fc = fleet.FleetConfig(n_tasks=3, placement="striped", helpers_per_task=3)
    eng = engine.Engine(device="cpu", devices=CPU8)
    a = eng.run_fleet(cfg, "ccp", 11, 30, fleet=fc)
    b = eng.run_fleet(cfg, "ccp", 11, 30, fleet=fc, shard=True)
    assert b.T.shape == (11, 3) and b.M == a.M and _equal(a, b)
    # The block policies' per-tenant loads (x_loads, (B, T, N)) join too.
    a = eng.run_fleet(cfg, "uncoded_mean", 11, 30, fleet=fc)
    b = eng.run_fleet(cfg, "uncoded_mean", 11, 30, fleet=fc, shard=True)
    assert _equal(a, b) and b.extras["loads"].shape == (11, 3, 6)
