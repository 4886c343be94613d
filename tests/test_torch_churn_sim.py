"""Port parity for the churn scenario model: ``ChurnConfig`` (validation and
properties), the phase and interval lookups bit for bit on the same times,
the dynamics samplers against the reference's in distribution,
``interop.dynamics_from_numpy``, the horizon cap under churn, and the
transport knobs and ``tfrc_ccp``, taken since the transport slice.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses

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
from repro_torch.core import policies as pol_pt
from repro_torch.core import simulator as sim_pt

CONFIGS = [
    dict(),
    dict(p_down=0.1, p_slow=0.2, drop_prob=0.05, outage_dist="lognormal"),
    dict(ge_p_bad=0.02, ge_p_good=0.2, ge_loss_bad=0.5, p_cell=0.1),
    dict(ge_p_bad=(0.4, 0.0), ge_loss_bad=1.0, ge_p_good=0.1),
    dict(ge_p_bad=[0.3, 0.02, 0.0], ge_p_good=(0.1, 0.5, 0.25), ge_loss_good=0.01),
    dict(outage_dist="geometric", outage_mean=2.0, rtt_mean=0.5, rtt_het=0.3),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_churn_config_properties_match_reference(kw):
    ref, port = sim_jax.ChurnConfig(**kw), sim_pt.ChurnConfig(**kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for prop in ("ge_classes", "ge_enabled", "cell_enabled", "ge_stationary_bad",
                 "ge_loss_rate", "rtt_enabled", "neutral"):
        assert getattr(ref, prop) == getattr(port, prop), prop
    assert ref.static_key() == port.static_key()
    params = port.ge_class_params()
    assert params.dtype == np.float64 and np.array_equal(params, ref.ge_class_params())
    hash(port)  # list knobs were normalized to tuples


@pytest.mark.parametrize("kw,match", [
    (dict(outage_dist="weibull"), "outage_dist"),
    (dict(ge_p_bad=(0.1, 0.2), ge_p_good=(0.1, 0.2, 0.3)), "class count"),
    (dict(rtt_dist="pareto"), "rtt_dist"),
    (dict(rtt_mean=-1.0), "rtt_mean"),
    (dict(rtt_het=1.5), "rtt_het"),
])
def test_churn_config_validation_matches_reference(kw, match):
    for mod in (sim_jax, sim_pt):
        with pytest.raises(ValueError, match=match):
            mod.ChurnConfig(**kw)


@pytest.mark.parametrize("rtt_dist", ["fixed", "lognormal", "cell"])
def test_transport_knobs_are_refused_with_their_roadmap_slice(rtt_dist):
    """Since the transport slice the knobs are no longer refused: the port
    takes every regime and validates it as the reference does, and the
    engine's static key carries it."""
    kw = dict(rtt_dist=rtt_dist, rtt_mean=0.5, rtt_het=0.2)
    ref, port = sim_jax.ChurnConfig(**kw), sim_pt.ChurnConfig(**kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port) and port.rtt_enabled
    assert port.static_key() == ref.static_key()
    assert eng_pt._parse_churn_static(port.static_key()) == eng_jax._parse_churn_static(
        ref.static_key())
    for bad, match in ((dict(kw, rtt_mean=-1.0), "rtt_mean"), (dict(kw, rtt_het=1.5), "rtt_het")):
        for mod in (sim_jax, sim_pt):
            with pytest.raises(ValueError, match=match):
                mod.ChurnConfig(**bad)


def test_registry_ports_the_churn_policies_and_still_refuses_tfrc():
    """Since the transport slice nothing is refused: the port registers
    exactly the reference's policy names, tfrc_ccp included."""
    assert {"adaptive_rate", "adaptive_rate_fb", "tfrc_ccp"} <= set(pol_pt.names())
    assert pol_pt.base.NOT_PORTED == {}
    assert set(pol_jax.names()) == set(pol_pt.names())
    assert pol_pt.get("tfrc_ccp").name == "tfrc_ccp"
    fb = pol_pt.get("adaptive_rate_fb")
    ref = pol_jax.get("adaptive_rate_fb")
    assert fb.uses_decoder and fb.outage_run == ref.outage_run == 2
    assert (fb.loss_ewma, fb.p_clip) == (ref.loss_ewma, ref.p_clip)
    assert pol_pt.get("adaptive_rate").outage_run == 4


@pytest.mark.parametrize("period,P", [(5.0, 16), (3.0, 7), (0.7, 16), (10.0, 4)])
def test_phase_lookup_matches_reference_bitwise(period, P):
    """The wrapping phase of float32 times, at exact multiples of
    ``period``, just below them, past the wrap ``P * period`` and at 0,
    picks the reference's entry."""
    rng = np.random.default_rng(int(period * 10) + P)
    B, N = 3, 40
    table = rng.uniform(0, 1, (B, N, P)).astype(np.float32)
    k = rng.integers(0, 4 * P, (B, N))
    mult = (k * np.float32(period)).astype(np.float32)
    t = np.where(rng.random((B, N)) < 0.5, mult,
                 np.nextafter(mult, np.float32(0))).astype(np.float32)
    t[:, :5] = rng.uniform(0, 1e4, (B, 5)).astype(np.float32)
    t[:, 5] = 0.0
    out = sim_pt._phase_lookup(torch.as_tensor(table), torch.as_tensor(t), period)
    for b in range(B):
        ref = sim_jax._phase_lookup(jnp.asarray(table[b]), jnp.asarray(t[b]), period)
        assert np.array_equal(out[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("shared", [False, True])
def test_interval_hit_matches_reference_bitwise(shared):
    """Per-helper (B, N, P) and shared (B, P) intervals, with ends that
    spill past the window, empty (+inf, -inf) intervals, and times at the
    interval edges and past the wrap: the reference's membership."""
    rng = np.random.default_rng(7)
    B, N, P, period = 3, 30, 8, 2.5
    window = P * period
    shape = (B, P) if shared else (B, N, P)
    start = (np.arange(P) * np.float32(period) + rng.uniform(0, period, shape)).astype(np.float32)
    dur = rng.lognormal(0.5, 0.8, shape).astype(np.float32)
    ev = rng.random(shape) < 0.6
    s = np.where(ev, start, np.inf).astype(np.float32)
    e = np.where(ev, start + dur, -np.inf).astype(np.float32)
    t = rng.uniform(0, 3 * window, (B, N)).astype(np.float32)
    edges = (s if shared else s[:, 0, :])[:, :4]  # times exactly at some starts
    t[:, :4] = np.where(np.isfinite(edges), edges, 0.0)
    t[:, 4] = np.float32(window)
    out = sim_pt._interval_hit(torch.as_tensor(s), torch.as_tensor(e), torch.as_tensor(t), window)
    assert out.shape == (B, N, P)
    for b in range(B):
        ref = sim_jax._interval_hit(jnp.asarray(s[b]), jnp.asarray(e[b]), jnp.asarray(t[b]),
                                    window)
        assert np.array_equal(out[b].numpy(), np.broadcast_to(np.asarray(ref), (N, P)))


@pytest.mark.parametrize("dist", ["phase", "geometric", "lognormal"])
def test_outage_durations_match_reference_in_distribution(dist):
    """The port's mirror of test_outage_duration_distributions: geometric
    durations are whole periods, log-normal ones continuous, both with the
    configured mean; moments against the reference's draws."""
    ch = sim_pt.ChurnConfig(period=5.0, outage_dist=dist, outage_mean=15.0,
                            outage_sigma=0.5, p_down=1.0)
    d = sim_pt._draw_durations(torch.Generator().manual_seed(0), ch, (20000,)).numpy()
    ref = np.asarray(sim_jax._draw_durations(
        jax.random.PRNGKey(0), sim_jax.ChurnConfig(**dataclasses.asdict(ch)), (20000,)))
    assert d.dtype == np.float32 and (d > 0).all()
    if dist == "phase":
        assert (d == 5.0).all() and (ref == 5.0).all()
        return
    assert np.allclose(d % 5.0, 0.0) == (dist == "geometric")
    assert abs(d.mean() - 15.0) < 2.0
    se = np.sqrt(d.var() / d.size + ref.var() / ref.size)
    assert abs(d.mean() - ref.mean()) < 5 * se, (d.mean(), ref.mean())
    assert abs(d.std() / ref.std() - 1) < 0.1


def test_geometric_durations_at_one_period():
    """outage_mean <= period: every geometric duration is one period (the
    reference's p = 1; torch's geometric_ takes p < 1 only)."""
    ch = sim_pt.ChurnConfig(period=5.0, outage_dist="geometric", outage_mean=3.0)
    d = sim_pt._draw_durations(torch.Generator().manual_seed(0), ch, (100,))
    assert (d == 5.0).all()


def _rate_close(port, ref, what):
    port, ref = np.asarray(port, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    p = 0.5 * (port.mean() + ref.mean())
    se = np.sqrt(p * (1 - p) * (1 / port.size + 1 / ref.size)) + 1e-12
    assert abs(port.mean() - ref.mean()) < 5 * se, (what, port.mean(), ref.mean())


def _both_dynamics(ch_kw, N=40, M=64, reps=24):
    cfg_j = sim_jax.ScenarioConfig(N=N, scenario=1, churn=sim_jax.ChurnConfig(**ch_kw))
    cfg_t = sim_pt.ScenarioConfig(N=N, scenario=1, churn=sim_pt.ChurnConfig(**ch_kw))
    ref = [sim_jax.draw_dynamics(k, cfg_j, M) for k in sim_jax.batch_keys(reps, seed0=5)]
    ref = {k: np.stack([np.asarray(d[k]) for d in ref]) for k in ref[0]}
    port = sim_pt.draw_dynamics(torch.Generator().manual_seed(5), cfg_t, reps, M)
    assert set(port) == set(ref)
    for k, v in port.items():
        assert tuple(v.shape) == ref[k].shape, k
        assert v.dtype == {"b": torch.bool, "f": torch.float32}[ref[k].dtype.kind], k
    return {k: v.numpy() for k, v in port.items()}, ref


def test_phase_dynamics_match_reference_in_distribution():
    port, ref = _both_dynamics(dict(p_down=0.15, p_slow=0.3, slowdown=4.0, drop_prob=0.1))
    _rate_close(port["drop"], ref["drop"], "drop")
    _rate_close(~port["up"], ~ref["up"], "p_down")
    _rate_close(port["speed"] != 1.0, ref["speed"] != 1.0, "p_slow")
    assert set(np.unique(port["speed"])) == set(np.unique(ref["speed"])) == {0.25, 1.0}


@pytest.mark.parametrize("dist", ["geometric", "lognormal"])
def test_interval_outages_match_reference_in_distribution(dist):
    port, ref = _both_dynamics(dict(p_down=0.2, outage_dist=dist, outage_mean=12.0,
                                    period=5.0))
    ev_p, ev_r = np.isfinite(port["out_start"]), np.isfinite(ref["out_start"])
    _rate_close(ev_p, ev_r, "p_down")
    for d in (port, ref):
        ev = np.isfinite(d["out_start"])
        assert (d["out_start"][ev] % 5.0 == 0).all()  # outages start at a boundary
        assert (d["out_end"][~ev] == -np.inf).all()
    dur_p = (port["out_end"] - port["out_start"])[ev_p]
    dur_r = (ref["out_end"] - ref["out_start"])[ev_r]
    se = np.sqrt(dur_p.var() / dur_p.size + dur_r.var() / dur_r.size)
    assert abs(dur_p.mean() - dur_r.mean()) < 5 * se, (dur_p.mean(), dur_r.mean())


def test_cell_events_match_reference_in_distribution():
    port, ref = _both_dynamics(dict(p_cell=0.3, cell_frac=0.6, period=5.0,
                                    outage_dist="lognormal", outage_mean=4.0))
    _rate_close(np.isfinite(port["cell_start"]), np.isfinite(ref["cell_start"]), "p_cell")
    _rate_close(port["cell_mask"], ref["cell_mask"], "cell_frac")
    for d in (port, ref):  # an event starts inside its own phase
        ev = np.isfinite(d["cell_start"])
        ph = np.broadcast_to(np.arange(d["cell_start"].shape[-1]) * 5.0, ev.shape)
        assert ((d["cell_start"][ev] >= ph[ev]) & (d["cell_start"][ev] < ph[ev] + 5.0)).all()


@pytest.mark.parametrize("kw", [
    dict(ge_p_bad=0.05, ge_p_good=0.2, ge_loss_bad=0.8, ge_loss_good=0.02),
    dict(ge_p_bad=(0.3, 0.02, 0.0), ge_p_good=(0.1, 0.5, 0.25), ge_loss_bad=0.9),
])
def test_ge_dynamics_match_reference_in_distribution(kw):
    port, ref = _both_dynamics(kw)
    _rate_close(port["ge_bad0"], ref["ge_bad0"], "ge_bad0")
    for k in ("ge_u_trans", "ge_u_loss"):
        assert 0.0 <= port[k].min() and port[k].max() < 1.0
        assert abs(port[k].mean() - 0.5) < 0.01
    if port["ge_params"].ndim == 2:
        assert np.array_equal(port["ge_params"], ref["ge_params"])
    else:  # per-helper classes: the same class shares
        cls_p = port["ge_params"][:, 0, :]
        cls_r = ref["ge_params"][:, 0, :]
        for v in np.unique(cls_r):
            _rate_close(cls_p == v, cls_r == v, f"class p_bad={v}")


def test_dynamics_from_numpy_casts_and_stacks():
    ch = sim_jax.ChurnConfig(ge_p_bad=(0.3, 0.0), p_cell=0.2, outage_dist="lognormal",
                             p_down=0.1)
    cfg = sim_jax.ScenarioConfig(N=6, scenario=1, churn=ch)
    per_rep = [sim_jax.draw_dynamics(k, cfg, 16) for k in sim_jax.batch_keys(2)]
    dyn = interop.dynamics_from_numpy(per_rep, device="cpu")
    stacked = interop.dynamics_from_numpy(
        {k: np.stack([np.asarray(d[k]) for d in per_rep]) for k in per_rep[0]},
        device="cpu")
    assert set(dyn) == set(per_rep[0]) == set(stacked)
    for k, v in dyn.items():
        assert v.dtype == {"b": torch.bool, "f": torch.float32}[np.asarray(per_rep[0][k]).dtype.kind]
        assert torch.equal(v, stacked[k]) and v.shape[0] == 2
        assert np.array_equal(v[1].numpy(), np.asarray(per_rep[1][k]))
    assert dyn["ge_params"].shape == (2, 4, 6)
    ints = interop.dynamics_from_numpy({"cls": np.arange(4, dtype=np.int64)[None]}, "cpu")
    assert ints["cls"].dtype == torch.int32
    floats = interop.dynamics_from_numpy({"ge_params": np.ones((1, 4))}, "cpu")
    assert floats["ge_params"].dtype == torch.float32  # never float64


def test_horizon_cap_under_churn_matches_reference():
    """Under churn the cap is 4(R+K), for the shared heuristic and for the
    engine's cap (block policies keep their own factor)."""
    ch = dict(drop_prob=0.1)
    for N, R in ((20, 200), (50, 1000), (8, 4000)):
        cj = sim_jax.ScenarioConfig(N=N, churn=sim_jax.ChurnConfig(**ch))
        ct = sim_pt.ScenarioConfig(N=N, churn=sim_pt.ChurnConfig(**ch))
        kk = R + ct.K(R)
        assert sim_pt._m_cap(ct, kk) == sim_jax._m_cap(cj, kk) == 4 * kk
        assert sim_pt._horizon_shared(ct, R) == sim_jax._horizon_shared(cj, R)
        for name in ("ccp", "adaptive_rate_fb", "hcmm"):
            assert (eng_pt._m_cap(ct, kk, pol_pt.get(name))
                    == eng_jax._m_cap(cj, kk, pol_jax.get(name)))


def test_draw_tables_draws_dynamics_after_the_packet_tables():
    """A churn config draws the same helpers and packet tables as the
    static one from the same seed, then its dynamics."""
    static = sim_pt.ScenarioConfig(N=6)
    churn = dataclasses.replace(static, churn=sim_pt.ChurnConfig(drop_prob=0.2))
    a = eng_pt.draw_tables(torch.Generator().manual_seed(4), static, 2, 50, 32)
    b = eng_pt.draw_tables(torch.Generator().manual_seed(4), churn, 2, 50, 32)
    for f in ("mu", "a", "rate", "beta", "d_up", "d_ack", "d_down"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.dyn is None and b.dyn["drop"].shape == (2, 6, 32)
    with pytest.raises(ValueError, match="dynamics"):
        eng_pt.simulate(a, churn, 50, "ccp")
