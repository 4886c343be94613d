"""Port parity for the control plane: the engine's per-packet loop fed
tables that the JAX reference drew, the golden replay through the port's
simulate-from-tables path, the port's own samplers against the reference's
in distribution, and the ``Engine`` entry points.

JAX's threefry draws cannot be reproduced with ``torch.Generator``, so
traces are compared on JAX-drawn tables (``interop.tables_from_numpy``) and
the samplers by moments only.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import json
import pathlib

import jax
import jax.numpy as jnp
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


def _jax_tables(cfg, keys, R, M):
    """The reference's per-rep draws (``engine._sim_one``'s key split),
    stacked on a leading rep axis, as numpy."""
    cols = {k: [] for k in ("mu", "a", "rate", "beta", "d_up", "d_ack", "d_down")}
    for key in keys:
        k_h, k_p = jax.random.split(key)
        mu, a, rate = sim_jax.draw_helpers(k_h, cfg)
        tabs = sim_jax.draw_packet_tables(k_p, cfg, mu, a, rate, M, R)
        for k, v in zip(cols, (mu, a, rate) + tuple(tabs)):
            cols[k].append(np.asarray(v))
    return {k: np.stack(v) for k, v in cols.items()}


def _pt_cfg(cfg):
    return sim_pt.ScenarioConfig(N=cfg.N, scenario=cfg.scenario,
                                 mu_choices=cfg.mu_choices, a_mode=cfg.a_mode,
                                 a_const=cfg.a_const, rate_lo=cfg.rate_lo,
                                 rate_hi=cfg.rate_hi, overhead=cfg.overhead,
                                 alpha=cfg.alpha)


PORTED = ["ccp", "best", "naive", "naive_oracle", "rateless_ccp", "uncoded_mean",
           "uncoded_mu", "hcmm"]


@pytest.mark.parametrize("policy", PORTED)
def test_policy_stream_traces_match_reference(policy):
    """Every trace of the per-packet loop, and the policy's summary, equal
    the reference's on the same tables: times at rtol 1e-6, the integer
    and boolean traces (``lost``, ``sym_id``) and the decoder summary
    bitwise."""
    cfg, R, M = sim_jax.ScenarioConfig(N=20, scenario=1), 400, 256
    tabs = _jax_tables(cfg, sim_jax.batch_keys(2, seed0=5), R, M)
    c = cfg.ccp_cfg(R)
    cfg_static = (c.Bx, c.Br, c.Back, c.alpha)
    t = interop.tables_from_numpy(**tabs, device="cpu")
    pol_t = eng_pt._as_policy(policy)
    aux_t = pol_t.prepare(_pt_cfg(cfg), R, c, t.mu, t.a, t.rate)
    out_t, sum_t = eng_pt.policy_stream(t.beta, t.d_up, t.d_ack, t.d_down,
                                        policy=pol_t, cfg_static=cfg_static,
                                        aux=aux_t)
    for r in range(2):
        pol_j = pol_jax.get(policy)
        aux_j = pol_j.prepare(cfg, R, c, tabs["mu"][r], tabs["a"][r], tabs["rate"][r])
        if "naive_to" in aux_j:
            np.testing.assert_allclose(aux_t["naive_to"][r].numpy(),
                                       np.asarray(aux_j["naive_to"]), rtol=1e-6, atol=0)
        out_j, sum_j = eng_jax.policy_stream(
            tabs["beta"][r], tabs["d_up"][r], tabs["d_ack"][r], tabs["d_down"][r],
            policy=pol_j, cfg_static=cfg_static, aux=aux_j)
        assert set(out_t) == set(out_j) and set(sum_t) == set(sum_j)
        for k, vj in list(out_j.items()) + list(sum_j.items()):
            vt, vj = (out_t[k] if k in out_t else sum_t[k])[r].numpy(), np.asarray(vj)
            assert vt.shape == vj.shape, k
            if vj.dtype.kind in "bi":
                assert np.array_equal(vt, vj), k
            else:
                np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=0, err_msg=k)
    if policy == "rateless_ccp":
        assert out_t["sym_id"].dtype == torch.int32


@pytest.mark.parametrize("policy", ["naive", "naive_oracle", "rateless_ccp"])
def test_simulate_matches_reference_run(policy):
    """The whole rep pipeline after the draw (prepare, loop, finalize,
    statistics) equals the reference's ``_sim_one`` on the same keys: T and
    efficiency at rtol 1e-6, valid, r_n and the extras exactly."""
    cfg, R, M = sim_jax.ScenarioConfig(N=20, scenario=1), 400, 256
    keys = sim_jax.batch_keys(2, seed0=9)
    tabs = _jax_tables(cfg, keys, R, M)
    res = eng_pt.simulate(interop.tables_from_numpy(**tabs, device="cpu"),
                          _pt_cfg(cfg), R, policy)
    ref = eng_jax._sim_batch_jit(keys, cfg, R, M, pol_jax.get(policy))
    assert set(res) == set(ref)
    for k, vj in ref.items():
        vt, vj = res[k].numpy(), np.asarray(vj)
        if vj.dtype.kind in "bi":
            assert np.array_equal(vt, vj), k
        else:
            np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=0, err_msg=k)


def test_rateless_pacing_equals_ccp_and_reports_decode_state():
    """rateless_ccp is Algorithm 1 bit for bit on the wire (same tx, tr,
    arrive and idle traces as ccp on the same tables); only the completion
    rule changes.  Engine.run surfaces the decoder state in extras."""
    cfg = sim_pt.ScenarioConfig(N=10, scenario=1)
    R = 200
    t = eng_pt.draw_tables(torch.Generator().manual_seed(0), cfg, 2, R, 256)
    c = cfg.ccp_cfg(R)
    outs = {}
    for mode in ("ccp", "rateless_ccp"):
        pol = eng_pt._as_policy(mode)
        aux = pol.prepare(cfg, R, c, t.mu, t.a, t.rate)
        outs[mode], _ = eng_pt.policy_stream(
            t.beta, t.d_up, t.d_ack, t.d_down, policy=pol,
            cfg_static=(c.Bx, c.Br, c.Back, c.alpha), aux=aux)
    for k in ("tx", "tr", "arrive", "idle"):
        assert torch.equal(outs["ccp"][k], outs["rateless_ccp"][k]), k
    res = eng_pt.Engine(device="cpu").run(cfg, "rateless_ccp", 2, R, seed=0)
    assert bool(res.valid.all())
    assert bool((res.extras["dec_count"] == R).all())
    assert bool(res.extras["dec_done"].all())
    assert set(res.keys()) >= {"T", "dec_count", "dec_done", "M"}
    # measured LT overhead: arrivals the decode consumed beyond R
    assert bool((res.r_n.sum(dim=1) - R >= 0).all())


@pytest.mark.parametrize("name", ["static_sc1_ccp", "static_sc1_best",
                                  "static_sc2_ccp", "static_sc1_naive"])
def test_golden_replay_through_port(name):
    g = GOLDEN[name]
    scenario = 2 if name.startswith("static_sc2") else 1
    policy = name.split("_")[-1]
    cfg = sim_jax.ScenarioConfig(N=20, scenario=scenario)
    # The goldens were drawn with JAX's earlier default threefry mode (not
    # partitionable); today's default draws other bits from the same keys.
    with jax.threefry_partitionable(False):
        tabs = _jax_tables(
            cfg, sim_jax.batch_keys(g["reps"], seed0=g.get("seed0", 0)), g["R"], g["M"])
    res = eng_pt.simulate(interop.tables_from_numpy(**tabs, device="cpu"),
                          _pt_cfg(cfg), g["R"], policy)
    assert res["T"].dtype == torch.float32
    np.testing.assert_allclose(res["T"].numpy(), np.float32(g["T"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(res["efficiency"].numpy(), np.float32(g["efficiency"]),
                               rtol=1e-6, atol=0)
    assert np.array_equal(res["r_n"].numpy(), np.asarray(g["r_n"]))
    assert np.array_equal(res["valid"].numpy(), np.asarray(g["valid"]))
    assert tabs["beta"].shape[-1] == g["M"]


def _jackknife(x):
    """Mean and variance of all of x (blocks, per_block) with jackknife
    standard errors over blocks: values within a block share a helper's
    draw, so blocks, not values, are the independent samples."""
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    n = x.shape[0]
    m1, m2 = x.mean(axis=1), (x * x).mean(axis=1)
    loo1 = (m1.sum() - m1) / (n - 1)
    loo2 = (m2.sum() - m2) / (n - 1)
    stats = np.stack([loo1, loo2 - loo1 ** 2])
    se = np.sqrt((n - 1) / n * ((stats - stats.mean(axis=1, keepdims=True)) ** 2).sum(axis=1))
    mean = m1.mean()
    return np.array([mean, m2.mean() - mean ** 2]), se


@pytest.mark.parametrize("scenario,a_mode", [(1, "const"), (2, "inv_mu")])
def test_samplers_match_reference_in_moments(scenario, a_mode):
    cfg_j = sim_jax.ScenarioConfig(N=3000, scenario=scenario, a_mode=a_mode)
    R, M = 400, 8
    tabs_j = _jax_tables(cfg_j, sim_jax.batch_keys(1, seed0=11), R, M)
    gen = torch.Generator().manual_seed(11)
    t = eng_pt.draw_tables(gen, _pt_cfg(cfg_j), 1, R, M)
    for k, vj in tabs_j.items():
        vt = getattr(t, k)[0].numpy()
        assert vt.dtype == np.float32 and vt.shape == vj[0].shape, k
        (st, se_t), (sj, se_j) = _jackknife(vt), _jackknife(vj[0])
        assert np.all(np.abs(st - sj) <= 5 * np.sqrt(se_t ** 2 + se_j ** 2) + 1e-12), (
            k, st, sj, se_t, se_j)


def test_engine_run_certifies_and_reproduces():
    cfg = sim_pt.ScenarioConfig(N=50, scenario=1)
    eng = eng_pt.Engine(device="cpu")
    res = eng.run(cfg, "ccp", 4, 1000, seed=0)
    best = eng.run(cfg, "best", 4, 1000, seed=torch.Generator().manual_seed(0))
    assert isinstance(res, eng_pt.RunResult) and res.policy == "ccp"
    assert res.T.shape == (4,) and res.efficiency.shape == (4, 50)
    assert bool(res.valid.all()) and bool(best.valid.all())
    assert torch.equal(res.mu, best.mu)  # same seed -> same helper draw
    # the reference suite's anchors (tests/test_simulator.py)
    assert float(res.T.mean()) <= 1.10 * float(best.T.mean())
    assert float(torch.nanmean(res.efficiency)) > 0.99
    again = eng.run(cfg, "ccp", 4, 1000, seed=0)
    assert torch.equal(res.T, again.T) and again.M == res.M
    assert set(res.as_dict()) >= {"T", "valid", "efficiency", "r_n", "M"}
    assert int(res.r_n.sum(dim=1).min()) >= 1000 + cfg.K(1000)


@pytest.mark.parametrize("tx_end", [False, True])
def test_completion_time_equals_reference_with_fewer_packets_than_k(tx_end):
    """With N*M < k the k-th arrival index clamps to the last packet and the
    certification is the reference's, on the same tables."""
    rng = np.random.default_rng(3)
    tr = rng.uniform(1.0, 50.0, (4, 5, 6)).astype(np.float32)
    tr[0] = 7.0  # every last packet ties the largest arrival: certified
    tr[1, :, -1] = tr[1].max()
    ends = rng.uniform(40.0, 60.0, (4, 5)).astype(np.float32)
    for k in (12, 30, 31, 45):
        t, valid = sim_pt.completion_time(torch.as_tensor(tr), k,
                                          tx_end=torch.as_tensor(ends) if tx_end else None)
        for r in range(4):
            tj, vj = sim_jax.completion_time(jnp.asarray(tr[r]), k,
                                             tx_end=jnp.asarray(ends[r]) if tx_end else None)
            assert float(t[r]) == float(tj) and bool(valid[r]) == bool(vj), (k, r)
    t, valid = sim_pt.completion_time(torch.as_tensor(tr), 45)
    assert bool(valid[0]) and bool(valid[1])  # the clamped rep certifies


def test_engine_doubles_the_horizon_until_certified(monkeypatch):
    cfg = sim_pt.ScenarioConfig(N=10, scenario=1)
    R = 200
    monkeypatch.setattr(sim_pt, "_horizon_shared", lambda cfg, R: 24)
    eng = eng_pt.Engine(device="cpu")
    short = eng.run(cfg, "ccp", 3, R, seed=1, M_override=24)
    # Enough packets for the k-th arrival (N*M >= R+K), but a fast helper
    # runs out of simulated packets before it: not certified.
    assert 10 * 24 >= R + cfg.K(R)
    assert short.M == 24 and not bool(short.valid.all())
    res = eng.run(cfg, "ccp", 3, R, seed=1)
    assert res.M == 48 and bool(res.valid.all())
    one = eng.run_one(cfg, "best", 400, seed=2)
    assert isinstance(one["T"], float) and one["efficiency"].shape == (10,)
    assert bool(one["valid"])


def _fewer_cards_than_asked(monkeypatch):
    """One card present (faked), two distinct ones asked for."""
    from repro_torch.launch import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.make_host_mesh(model=1).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 2 distinct devices"):
        mesh.make_host_mesh(model=2)


def test_engine_refusals(monkeypatch):
    eng = eng_pt.Engine(device="cpu")
    cfg = sim_pt.ScenarioConfig(N=4)
    with pytest.raises(ValueError, match="known policies"):
        eng.run(cfg, "nope", 2, 100)
    with pytest.raises(ValueError, match="R must be"):
        eng.run(cfg, "ccp", 2, 0)
    # shard=True runs (since slice C5a): the reps split over the devices
    # given, bitwise the unsharded run; a mesh of more distinct cards than
    # the host has raises.
    sharded = eng_pt.Engine(device="cpu", shard=True, devices=["cpu"] * 3).run(cfg, "ccp", 2, 100)
    assert torch.equal(sharded.T, eng.run(cfg, "ccp", 2, 100).T)
    _fewer_cards_than_asked(monkeypatch)
    # Since the transport slice tfrc_ccp and the transport knobs are taken,
    # and every reference policy is ported.
    transport = sim_pt.ScenarioConfig(N=4, churn=sim_pt.ChurnConfig(rtt_dist="fixed",
                                                                    rtt_mean=0.1))
    res = eng.run(transport, "tfrc_ccp", 2, 100)
    assert res.policy == "tfrc_ccp" and res.extras["p_ev"].shape == (2, 4)
    from repro_torch.core import policies as pol_pt
    assert set(pol_jax.names()) == set(pol_pt.names()) and not pol_pt.base.NOT_PORTED


def test_horizon_heuristics_match_reference():
    for cfg in (sim_jax.ScenarioConfig(N=100), sim_jax.ScenarioConfig(N=10, a_mode="inv_mu")):
        for R in (200, 2000, 8000):
            assert sim_pt._horizon_shared(_pt_cfg(cfg), R) == sim_jax._horizon_shared(cfg, R)
            mu, a, w = sim_jax.class_weights(cfg)
            assert all(np.array_equal(x, y) for x, y in
                       zip((mu, a, w), sim_pt.class_weights(_pt_cfg(cfg))))
            assert (sim_pt._horizon(_pt_cfg(cfg), mu, a, R)
                    == sim_jax._horizon(cfg, mu, a, R))
