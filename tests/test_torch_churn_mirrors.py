"""The reference's churn tests, mirrored on the port's own draws
(``test_simulator_dynamics.py``, ``test_policies.py``'s churn cases and
``test_decode.py``'s churn cases): the same configs, sizes and anchors,
through the port's ``Engine`` on the CPU.  Hand-built dynamics carry a
leading rep axis of 1.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import numpy as np
import pytest
import torch

from repro_torch.core import decode, engine, fountain, policies, simulator
from repro_torch.core.decode import peeling

ENG = engine.Engine(device="cpu")
R = 400


def _stream(beta, d_up, d_ack, d_down, mode, cfg_static, **kw):
    """policy_stream under a registry name; returns the trace dict."""
    outs, _ = engine.policy_stream(beta, d_up, d_ack, d_down, policy=policies.get(mode),
                                   cfg_static=cfg_static, **kw)
    return {k: v[0].numpy() for k, v in outs.items()}


def _const(N, M, beta, up=0.01, ack=0.001, down=0.01):
    return tuple(torch.full((1, N, M), v) for v in (beta, up, ack, down))


def test_dead_helper_backs_off_and_task_completes():
    """Helper 0 is up in phase 0 only, then down for good: its TTI backoff
    doubles per timeout up to the cap, the survivors keep backoff 1, and
    the k-th arrival is still certified from the survivors."""
    N, M, period, cap = 3, 64, 4.0, 8.0
    n_phases = 512  # wrap far beyond the backed-off probe span
    up = torch.ones((1, N, n_phases), dtype=torch.bool)
    up[0, 0, 1:] = False
    dyn = dict(drop=torch.zeros((1, N, M), dtype=torch.bool), up=up,
               speed=torch.ones((1, N, n_phases)))
    outs = _stream(*_const(N, M, 1.0), "ccp", cfg_static=(8.0 * R, 8.0, 1.0, 0.25),
                   churn_static=(period, cap), dyn=dyn, a=torch.full((1, N), 0.5))
    backoff, lost = outs["backoff"], outs["lost"]
    assert lost[0].sum() > 0 and lost[1:].sum() == 0
    b0 = backoff[0][lost[0]]
    assert b0.max() == cap and (np.diff(b0) >= 0).all()
    assert set(np.unique(b0[1:] / b0[:-1])).issubset({1.0, 2.0})
    assert (backoff[1:] == 1.0).all()
    t, valid = simulator.completion_time(torch.as_tensor(outs["tr"])[None], 40,
                                         tx_end=torch.as_tensor(outs["tx_end"])[None])
    assert bool(valid[0]) and np.isfinite(float(t[0]))
    assert np.diff(outs["tx"][0][lost[0]]).min() > 0


def test_rejoining_helper_backoff_resets():
    N, M, period, cap = 2, 96, 3.0, 8.0
    up = torch.ones((1, N, 16), dtype=torch.bool)
    up[0, 0, 1:3] = False
    dyn = dict(drop=torch.zeros((1, N, M), dtype=torch.bool), up=up,
               speed=torch.ones((1, N, 16)))
    outs = _stream(*_const(N, M, 0.5), "ccp", cfg_static=(8.0 * R, 8.0, 1.0, 0.25),
                   churn_static=(period, cap), dyn=dyn, a=torch.full((1, N), 0.25))
    lost0, backoff0 = outs["lost"][0], outs["backoff"][0]
    assert lost0.sum() > 0
    last_lost = np.nonzero(lost0)[0].max()
    assert not lost0[last_lost + 1:].any()
    assert backoff0[lost0].max() > 1.0
    assert (backoff0[last_lost + 1:] == 1.0).all()


def test_cell_outage_takes_members_down_simultaneously():
    """Hand-built single cell event [2, 4): members lose exactly the
    packets arriving in the window, the non-member loses nothing."""
    N, M, P = 3, 64, 8
    dyn = dict(drop=torch.zeros((1, N, M), dtype=torch.bool), speed=torch.ones((1, N, P)),
               up=torch.ones((1, N, P), dtype=torch.bool),
               cell_start=torch.tensor([[2.0]]), cell_end=torch.tensor([[4.0]]),
               cell_mask=torch.tensor([[[True], [True], [False]]]))
    outs = _stream(*_const(N, M, 0.25), "best", cfg_static=(8.0 * R, 8.0, 1.0, 0.25),
                   churn_static=(5.0, 8.0, "phase", False, True), dyn=dyn,
                   a=torch.full((1, N), 0.1))
    lost, arrive = outs["lost"], outs["arrive"]
    in_win = (arrive >= 2.0) & (arrive < 4.0)
    assert lost[2].sum() == 0 and lost[0].sum() > 0 and lost[1].sum() > 0
    assert (lost[:2] & in_win[:2] == in_win[:2]).all()


def test_slowdown_phases_increase_completion_time():
    base = simulator.ScenarioConfig(N=20, scenario=1, churn=simulator.ChurnConfig(
        period=5.0, p_slow=0.0, slowdown=4.0))
    slowed = simulator.ScenarioConfig(N=20, scenario=1, churn=simulator.ChurnConfig(
        period=5.0, p_slow=0.8, slowdown=4.0))
    t_base = float(ENG.run(base, "ccp", 4, R).T.mean())
    t_slow = float(ENG.run(slowed, "ccp", 4, R).T.mean())
    assert t_slow > 1.5 * t_base


def _lossy_cfg():
    return simulator.ScenarioConfig(
        N=20, scenario=1, mu_choices=(1.0, 3.0, 9.0), a_mode="inv_mu",
        rate_lo=1e6, rate_hi=2e6,
        churn=simulator.ChurnConfig(period=10.0, p_down=0.05, p_slow=0.1,
                                    drop_prob=0.2, max_backoff=8.0))


def test_ccp_degrades_gracefully_vs_naive():
    t = {m: float(ENG.run(_lossy_cfg(), m, 6, 300).T.mean())
         for m in ("ccp", "best", "naive")}
    assert t["ccp"] < t["naive"]
    assert t["ccp"] / t["best"] < 0.6 * (t["naive"] / t["best"])


def test_naive_oracle_timer_between_naive_and_best():
    t = {m: float(ENG.run(_lossy_cfg(), m, 6, 300).T.mean())
         for m in ("best", "naive", "naive_oracle")}
    assert t["best"] < t["naive_oracle"] < t["naive"], t


def test_ge_stationary_loss_rate():
    ch = simulator.ChurnConfig(ge_p_bad=0.05, ge_p_good=0.2, ge_loss_bad=0.8,
                               ge_loss_good=0.02)
    cfg = simulator.ScenarioConfig(N=100, scenario=1, churn=ch)
    measured = float(ENG.run(cfg, "ccp", 3, 400).lost_frac.mean())
    assert abs(measured - ch.ge_loss_rate) < 0.15 * ch.ge_loss_rate, measured


def test_ge_losses_are_bursty():
    """Loss runs have mean length ~1/ge_p_good, far longer than i.i.d.
    loss at the same marginal rate would give."""
    ch = simulator.ChurnConfig(ge_p_bad=0.02, ge_p_good=0.1, ge_loss_bad=1.0,
                               ge_loss_good=0.0)
    cfg = simulator.ScenarioConfig(N=100, scenario=1, churn=ch)
    t = engine.draw_tables(torch.Generator().manual_seed(0), cfg, 1, 400, 256)
    outs = _stream(t.beta, t.d_up, t.d_ack, t.d_down, "best",
                   cfg_static=(8.0 * 400, 8.0, 1.0, 0.25), churn_static=ch.static_key(),
                   dyn=t.dyn, a=t.a)
    runs = []
    for row in outs["lost"]:
        edges = np.diff(np.concatenate([[0], row.astype(int), [0]]))
        runs += list(np.nonzero(edges == -1)[0] - np.nonzero(edges == 1)[0])
    mean_run = np.mean(runs)
    assert mean_run > 3.0 and abs(mean_run - 10.0) < 5.0, mean_run


def test_duration_outages_last_longer_than_phase_outages():
    base = dict(period=5.0, p_down=0.1, max_backoff=8.0)
    cfg_p = simulator.ScenarioConfig(N=30, scenario=1, churn=simulator.ChurnConfig(**base))
    cfg_g = simulator.ScenarioConfig(N=30, scenario=1, churn=simulator.ChurnConfig(
        outage_dist="geometric", outage_mean=20.0, **base))
    lost_p = float(ENG.run(cfg_p, "ccp", 4, 300).lost_frac.mean())
    lost_g = float(ENG.run(cfg_g, "ccp", 4, 300).lost_frac.mean())
    assert lost_g > 1.5 * lost_p, (lost_p, lost_g)


def test_uncoded_under_churn_is_brittle_ccp_is_not():
    cfg = simulator.ScenarioConfig(N=10, scenario=1, churn=simulator.ChurnConfig(
        drop_prob=0.2, max_backoff=8.0))
    unc = ENG.run(cfg, "uncoded_mean", 3, 200)
    ccp = ENG.run(cfg, "ccp", 3, 200)
    assert torch.isinf(unc.T).all()
    assert torch.isfinite(ccp.T[ccp.valid]).all() and bool(ccp.valid.any())


def _burst_cfg(pb, n=20):
    return simulator.ScenarioConfig(
        N=n, scenario=1, mu_choices=(1.0, 3.0, 9.0), a_mode="inv_mu",
        rate_lo=1e6, rate_hi=2e6,
        churn=simulator.ChurnConfig(period=10.0, max_backoff=8.0, ge_p_bad=pb,
                                    ge_p_good=0.25, ge_loss_good=0.0, ge_loss_bad=0.9))


def test_adaptive_rate_beats_fixed_k_ccp_under_burst_loss():
    ccp = ENG.run(_burst_cfg(0.06), "ccp", 6, 300)
    ada = ENG.run(_burst_cfg(0.06), "adaptive_rate", 6, 300)
    assert bool(ccp.valid.all() and ada.valid.all())
    assert float(ada.T.mean()) < float(ccp.T.mean())
    p_hat = float(ada.extras["p_hat"].mean())
    expected = _burst_cfg(0.06).churn.ge_loss_rate
    assert abs(p_hat - expected) < 0.6 * expected, (p_hat, expected)


def test_heterogeneous_ge_fast_and_slow_faders_in_one_cell():
    ch = simulator.ChurnConfig(ge_p_bad=(0.5, 0.0), ge_p_good=0.1, ge_loss_bad=1.0,
                               ge_loss_good=0.0)
    cfg = simulator.ScenarioConfig(N=40, scenario=1, churn=ch)
    t = engine.draw_tables(torch.Generator().manual_seed(0), cfg, 1, 400, 192)
    assert t.dyn["ge_params"].shape == (1, 4, 40)
    fading = t.dyn["ge_params"][0, 0].numpy() > 0
    assert fading.any() and not fading.all()
    outs = _stream(t.beta, t.d_up, t.d_ack, t.d_down, "best",
                   cfg_static=(8.0 * 400, 8.0, 1.0, 0.25), churn_static=ch.static_key(),
                   dyn=t.dyn, a=t.a)
    assert outs["lost"][~fading].sum() == 0
    assert (outs["lost"][fading].mean(axis=1) > 0.3).all()


def test_homogeneous_ge_scalar_path_shape():
    cfg = simulator.ScenarioConfig(N=10, scenario=1, churn=simulator.ChurnConfig(ge_p_bad=0.1))
    dyn = simulator.draw_dynamics(torch.Generator().manual_seed(1), cfg, 3, 32)
    assert dyn["ge_params"].shape == (3, 4) and dyn["ge_params"].dtype == torch.float32


def test_adaptive_fb_stops_sending_after_decode_time():
    """Once the decode succeeds and the send clock passes decode_t_done,
    the stream stops for good, and the unsent slots are non-events."""
    R = 200
    cfg = simulator.ScenarioConfig(N=10, scenario=1, churn=simulator.ChurnConfig(
        drop_prob=0.1, max_backoff=8.0))
    M = 4 * (R + cfg.K(R))
    t = engine.draw_tables(torch.Generator().manual_seed(1), cfg, 2, R, M)
    c = cfg.ccp_cfg(R)
    pol = policies.get("adaptive_rate_fb")
    aux = pol.prepare(cfg, R, c, t.mu, t.a, t.rate)
    peeling.host_syncs = 0
    outs, psum = engine.policy_stream(
        t.beta, t.d_up, t.d_ack, t.d_down, policy=pol,
        cfg_static=(c.Bx, c.Br, c.Back, c.alpha), churn_static=cfg.churn.static_key(),
        dyn=t.dyn, a=t.a, aux=aux)
    assert peeling.host_syncs >= M  # one loop test a step at least, and counted
    tx = outs["tx"].numpy()
    assert np.isinf(tx).any(axis=(1, 2)).all()
    for row in tx.reshape(-1, M):
        stopped = np.isinf(row)
        if stopped.any():
            assert stopped[stopped.argmax():].all()
    assert not outs["lost"].numpy()[np.isinf(tx)].any()
    assert (outs["idle"].numpy()[np.isinf(tx)] == 0).all()
    assert bool(psum["dec_done"].all())


def test_rateless_overhead_within_robust_soliton_bound_under_drop():
    R, p = 400, 0.1
    cfg = simulator.ScenarioConfig(N=20, scenario=1, mu_choices=(2.0,),
                                   churn=simulator.ChurnConfig(drop_prob=p, max_backoff=8.0))
    res = ENG.run(cfg, "rateless_ccp", 6, R)
    assert bool(res.valid.all())
    overhead = res.r_n.sum(dim=1).numpy() - R
    assert (overhead >= 0).all()
    mean_ov = float(overhead.mean())
    k_bound = None
    for K in (R // 8, R // 4, R // 2, R):
        stats = fountain.decode_failure_prob(R, K, int(np.ceil(p * (R + K))), trials=12,
                                             seed=0)
        if stats["peel_stall"] <= 0.5:
            k_bound = K
            break
    assert k_bound is not None and mean_ov <= k_bound, (mean_ov, k_bound)
    offline = decode.offline_overhead_samples(R, decode.make_decoder_code(R), p,
                                              trials=8, seed=3)
    ok = offline[offline >= 0]
    assert ok.size > 0
    assert mean_ov / R <= (ok.mean() / R) * 1.5 + 0.05, (mean_ov, ok.mean())


@pytest.mark.parametrize("policy", ["ccp", "adaptive_rate", "adaptive_rate_fb"])
def test_engine_run_one_runs_churn(policy):
    cfg = simulator.ScenarioConfig(N=10, scenario=1, churn=simulator.ChurnConfig(
        drop_prob=0.1, p_down=0.05))
    one = ENG.run_one(cfg, policy, 150, seed=3)
    assert bool(one["valid"]) and np.isfinite(one["T"])
    assert one["lost_frac"].max() > 0 and one["M"] <= 4 * (150 + cfg.K(150))
