"""Port parity for the churn branch of the engine: the per-packet loop fed
tables *and* churn dynamics that the JAX reference drew
(``interop.tables_from_numpy(..., dyn=...)``), the four churn goldens
replayed through the port's simulate-from-tables path, the whole rep
pipeline against the reference's ``_sim_one``, and a neutral
``ChurnConfig`` against the static path on the port's own draws.

Every float trace is compared bit for bit: the port rounds as the
reference's XLA CPU build does, including the two expressions that build
contracts into a fused multiply-add (``adaptive_rate``'s loss EWMA and its
scaled pacing step, ``torch.addcmul`` in the port).
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as eng_jax
from repro.core import policies as pol_jax
from repro.core import simulator as sim_jax
from repro_torch import interop
from repro_torch.core import engine as eng_pt
from repro_torch.core import simulator as sim_pt

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "policy_equivalence.json").read_text())

PORTED = ["ccp", "best", "naive", "naive_oracle", "uncoded_mean", "uncoded_mu", "hcmm",
          "rateless_ccp", "adaptive_rate", "adaptive_rate_fb"]


def jax_tables(cfg, keys, R, M):
    """The reference's per-rep draws as ``engine._sim_one`` makes them
    (helpers and packet tables from ``split(key)``, dynamics from
    ``fold_in(key, 0xC0DE)``), stacked over reps as numpy, and the per-rep
    dynamics dicts."""
    cols = {k: [] for k in ("mu", "a", "rate", "beta", "d_up", "d_ack", "d_down")}
    dyns = []
    for key in keys:
        k_h, k_p = jax.random.split(key)
        mu, a, rate = sim_jax.draw_helpers(k_h, cfg)
        tabs = sim_jax.draw_packet_tables(k_p, cfg, mu, a, rate, M, R)
        for k, v in zip(cols, (mu, a, rate) + tuple(tabs)):
            cols[k].append(np.asarray(v))
        if cfg.churn is not None:
            dyn = sim_jax.draw_dynamics(jax.random.fold_in(key, 0xC0DE), cfg, M)
            dyns.append({k: np.asarray(v) for k, v in dyn.items()})
    return {k: np.stack(v) for k, v in cols.items()}, dyns


def pt_cfg(cfg):
    """The port's ScenarioConfig (and ChurnConfig) equal to a reference one."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.churn is not None:
        kw["churn"] = sim_pt.ChurnConfig(**dataclasses.asdict(cfg.churn))
    return sim_pt.ScenarioConfig(**kw)


def port_tables(tabs, dyns):
    return interop.tables_from_numpy(**tabs, dyn=dyns or None, device="cpu")


def assert_bitwise(vt, vj, key):
    vt, vj = np.asarray(vt), np.asarray(vj)
    # same kind; the port's integer counts (r_n) are int64
    assert vt.shape == vj.shape and vt.dtype.kind == vj.dtype.kind, (key, vt.dtype, vj.dtype)
    assert vj.dtype.kind != "f" or vt.dtype == vj.dtype, (key, vt.dtype, vj.dtype)
    assert np.array_equal(vt, vj, equal_nan=vj.dtype.kind == "f"), (
        key, int((vt != vj).sum()))


def _golden_churn():
    # tests/test_policies.py's churn golden config
    return sim_jax.ChurnConfig(
        period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05,
        ge_p_bad=0.02, ge_p_good=0.2, ge_loss_bad=0.5,
        p_cell=0.1, cell_frac=0.5, outage_dist="lognormal",
        outage_mean=4.0, outage_sigma=0.5, max_backoff=8.0)


# One regime per outage law, GE homogeneous and per-class, and cell outages.
REGIMES = {
    "phase": sim_jax.ChurnConfig(period=4.0, p_down=0.2, p_slow=0.3, drop_prob=0.05),
    "geometric": sim_jax.ChurnConfig(period=3.0, p_down=0.2, p_slow=0.2, drop_prob=0.05,
                                     outage_dist="geometric", outage_mean=9.0),
    "lognormal": sim_jax.ChurnConfig(period=4.0, p_down=0.25, p_slow=0.2, drop_prob=0.05,
                                     outage_dist="lognormal", outage_mean=6.0),
    "ge": sim_jax.ChurnConfig(period=5.0, ge_p_bad=0.08, ge_p_good=0.25,
                              ge_loss_good=0.02, ge_loss_bad=0.9),
    "ge_classes": sim_jax.ChurnConfig(period=5.0, ge_p_bad=(0.3, 0.02, 0.0),
                                      ge_p_good=(0.1, 0.5, 0.25), ge_loss_bad=0.9,
                                      drop_prob=0.02),
    "cell": sim_jax.ChurnConfig(period=2.0, n_phases=8, p_cell=0.4, cell_frac=0.6,
                                drop_prob=0.05, outage_dist="lognormal",
                                outage_mean=3.0),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("policy", PORTED)
def test_churn_policy_stream_traces_match_reference(policy, regime):
    """Every trace of the churn loop (tx, tr, arrive, idle, beta, lost,
    backoff, tx_end and, for the decoder policies, sym_id) and the policy's
    summary equal the reference's bit for bit on the reference's tables."""
    cfg = sim_jax.ScenarioConfig(N=8, scenario=1, churn=REGIMES[regime])
    R, M = 48, 96
    tabs, dyns = jax_tables(cfg, sim_jax.batch_keys(2, seed0=3), R, M)
    c = cfg.ccp_cfg(R)
    cfg_static = (c.Bx, c.Br, c.Back, c.alpha)
    t = port_tables(tabs, dyns)
    pol_t = eng_pt._as_policy(policy)
    aux_t = pol_t.prepare(pt_cfg(cfg), R, c, t.mu, t.a, t.rate)
    out_t, sum_t = eng_pt.policy_stream(
        t.beta, t.d_up, t.d_ack, t.d_down, policy=pol_t, cfg_static=cfg_static,
        churn_static=cfg.churn.static_key(), dyn=t.dyn, a=t.a, aux=aux_t)
    lost = 0
    for r in range(2):
        pol_j = pol_jax.get(policy)
        aux_j = pol_j.prepare(cfg, R, c, tabs["mu"][r], tabs["a"][r], tabs["rate"][r])
        out_j, sum_j = eng_jax.policy_stream(
            tabs["beta"][r], tabs["d_up"][r], tabs["d_ack"][r], tabs["d_down"][r],
            policy=pol_j, cfg_static=cfg_static, churn_static=cfg.churn.static_key(),
            dyn=dyns[r], a=tabs["a"][r], aux=aux_j)
        assert set(out_t) == set(out_j) and set(sum_t) == set(sum_j)
        for k, vj in list(out_j.items()) + list(sum_j.items()):
            assert_bitwise((out_t[k] if k in out_t else sum_t[k])[r].numpy(), vj, k)
        lost += int(np.asarray(out_j["lost"]).sum())
    assert lost > 0  # the regime does lose packets


@pytest.mark.parametrize("name", ["churn_ccp", "churn_best", "churn_naive",
                                  "churn_naive_oracle"])
def test_churn_golden_replay_through_port(name):
    """The four churn goldens through the port's simulate on the tables and
    dynamics the reference draws from the goldens' keys (old threefry
    mode): T and efficiency at rtol 1e-6; r_n, valid, max_backoff and
    lost_frac exactly."""
    g = GOLDEN[name]
    policy = name[len("churn_"):]
    cfg = sim_jax.ScenarioConfig(N=16, scenario=1, churn=_golden_churn())
    with jax.threefry_partitionable(False):
        tabs, dyns = jax_tables(
            cfg, sim_jax.batch_keys(g["reps"], seed0=g.get("seed0", 0)), g["R"], g["M"])
    res = eng_pt.simulate(port_tables(tabs, dyns), pt_cfg(cfg), g["R"], policy)
    np.testing.assert_allclose(res["T"].numpy(), np.float32(g["T"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(res["efficiency"].numpy(), np.float32(g["efficiency"]),
                               rtol=1e-6, atol=0)
    assert np.array_equal(res["r_n"].numpy(), np.asarray(g["r_n"]))
    assert np.array_equal(res["valid"].numpy(), np.asarray(g["valid"]))
    assert np.array_equal(res["max_backoff"].numpy(), np.float32(g["max_backoff"]))
    assert np.array_equal(res["lost_frac"].numpy(), np.float32(g["lost_frac"]))
    assert tabs["beta"].shape[-1] == g["M"]


@pytest.mark.parametrize("policy", ["ccp", "naive", "uncoded_mean", "hcmm", "rateless_ccp",
                                    "adaptive_rate", "adaptive_rate_fb"])
def test_churn_simulate_matches_reference_run(policy):
    """The whole rep pipeline after the draw under churn (prepare, loop,
    finalize with tx_end, statistics) equals the reference's ``_sim_one``
    on the same keys, every output bit for bit but the efficiency (rtol
    1e-6: its sums over M run in another order than XLA's); the block
    policies' blocks that lost a packet finish at +inf."""
    cfg = sim_jax.ScenarioConfig(N=10, scenario=1, churn=_golden_churn())
    R, M = 100, 192
    keys = sim_jax.batch_keys(3, seed0=2)
    tabs, dyns = jax_tables(cfg, keys, R, M)
    res = eng_pt.simulate(port_tables(tabs, dyns), pt_cfg(cfg), R, policy)
    ref = eng_jax._sim_batch_jit(keys, cfg, R, M, pol_jax.get(policy))
    assert set(res) == set(ref)
    for k, vj in ref.items():
        if k == "efficiency":
            np.testing.assert_allclose(res[k].numpy(), np.asarray(vj), rtol=1e-6, atol=0)
        else:
            assert_bitwise(res[k].numpy(), vj, k)
    if policy in ("uncoded_mean", "hcmm"):
        assert np.isinf(res["T"].numpy()).any()


def test_neutral_churn_dynamics_from_reference_are_static():
    """A neutral ChurnConfig's dynamics, drawn by the reference, leave the
    port's loop equal to the static loop on the same tables."""
    ch = sim_jax.ChurnConfig(outage_dist="geometric")
    cfg = sim_jax.ScenarioConfig(N=8, scenario=1, churn=ch)
    tabs, dyns = jax_tables(cfg, sim_jax.batch_keys(2, seed0=1), 64, 80)
    t = port_tables(tabs, dyns)
    static = dataclasses.replace(pt_cfg(cfg), churn=None)
    for policy in ("ccp", "adaptive_rate"):
        a = eng_pt.simulate(t, pt_cfg(cfg), 64, policy)
        b = eng_pt.simulate(dataclasses.replace(t, dyn=None), static, 64, policy)
        for k in a:
            assert torch.equal(a[k].nan_to_num(), b[k].nan_to_num()), (policy, k)


@pytest.mark.parametrize("outage_dist", ["phase", "geometric", "lognormal"])
@pytest.mark.parametrize("policy", PORTED)
def test_neutral_churn_is_bit_for_bit_static(policy, outage_dist):
    """The port's mirror of test_simulator_dynamics.py's test: a
    ChurnConfig with every loss knob at zero, whatever its structural
    knobs, is numerically invisible on the port's own draws (the dynamics
    are drawn after the packet tables, from the same generator)."""
    static = sim_pt.ScenarioConfig(N=12, scenario=1)
    neutral = dataclasses.replace(static, churn=sim_pt.ChurnConfig(
        outage_dist=outage_dist, ge_p_bad=0.0, p_cell=0.0, cell_frac=0.9))
    assert neutral.churn.neutral
    eng = eng_pt.Engine(device="cpu")
    s = eng.run_one(static, policy, 200, seed=7, M_override=128)
    n = eng.run_one(neutral, policy, 200, seed=7, M_override=128)
    assert np.array_equal(np.float32(s["T"]), np.float32(n["T"]))
    for k in ("r_n", "efficiency", "valid"):
        assert np.array_equal(s[k], n[k], equal_nan=k == "efficiency"), k
    assert (n["lost_frac"] == 0).all()
    assert (n["max_backoff"] == 1.0).all()


def test_adaptive_rate_equals_ccp_without_churn():
    """With nothing to adapt to, the code-rate policy is numerically
    invisible: p_hat stays 0 and every result equals CCP's."""
    cfg = sim_pt.ScenarioConfig(N=15, scenario=1)
    eng = eng_pt.Engine(device="cpu")
    ccp = eng.run(cfg, "ccp", 3, 300, seed=0)
    ada = eng.run(cfg, "adaptive_rate", 3, 300, seed=0)
    for k in ("T", "r_n", "valid", "max_backoff"):
        assert torch.equal(getattr(ccp, k), getattr(ada, k)), k
    assert bool((ada.extras["p_hat"] == 0).all())
