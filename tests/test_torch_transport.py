"""Port parity for the transport layer's primitives and the engine's
transport contract on the port's own draws: the RTT tables against the
reference's in distribution, ``observation_delay``, ``tfrc_send_interval``
and ``loss_event_update`` bit for bit against the reference's (XLA CPU)
results, RTT=0 transparency for every registered policy on the static path
and under churn, open-loop policies unchanged at any RTT, and ``tfrc_ccp``.

The trace parity on the reference's tables is in
``test_torch_transport_engine.py``, the reference's actual outputs where its
own transport tests fail in ``test_torch_transport_pinned.py``.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulator as sim_jax
from repro.core import transport as tr_jax
from repro_torch.core import engine as eng_pt
from repro_torch.core import policies as pol_pt
from repro_torch.core import simulator as sim_pt
from repro_torch.core import transport as tr_pt

ENG = eng_pt.Engine(device="cpu")
SPINE_FIELDS = ("T", "efficiency", "r_n", "valid", "max_backoff", "lost_frac")
# tests/test_transport.py's churn mix: i.i.d. drop, GE bursts, outages, cells.
CHURN = sim_pt.ChurnConfig(period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05,
                           ge_p_bad=0.03, ge_p_good=0.25, ge_loss_bad=0.5,
                           p_cell=0.05, cell_frac=0.5, max_backoff=8.0)
OPEN_LOOP = ("best", "uncoded_mean", "uncoded_mu", "hcmm")


def _with_rtt(ch, **kw):
    return dataclasses.replace(ch, **dict(dict(rtt_dist="fixed", rtt_mean=0.0), **kw))


def _same(a, b) -> bool:
    return torch.equal(a.nan_to_num(), b.nan_to_num()) and torch.equal(a.isnan(), b.isnan())


# ---------------------------------------------------------------------------
# Config surface and tables
# ---------------------------------------------------------------------------

def test_rtt_enabled_neutral_and_static_key_match_reference():
    for kw in (dict(), dict(rtt_dist="fixed", rtt_mean=1.0), dict(rtt_dist="fixed"),
               dict(rtt_dist="cell", rtt_mean=1.0, p_down=0.1)):
        ref, port = sim_jax.ChurnConfig(**kw), sim_pt.ChurnConfig(**kw)
        assert (ref.rtt_enabled, ref.neutral, ref.static_key()) == (
            port.rtt_enabled, port.neutral, port.static_key())
    assert sim_pt.RTT_DISTS == tr_pt.RTT_DISTS == tr_jax.RTT_DISTS


@pytest.mark.parametrize("rtt_dist", ["fixed", "lognormal", "cell"])
def test_draw_dynamics_appends_the_transport_tables(rtt_dist):
    """The transport tables come after every churn table: turning transport
    on leaves each churn draw as it was; their keys and shapes are the
    reference's."""
    base = sim_pt.ScenarioConfig(N=6, churn=CHURN)
    on = dataclasses.replace(base, churn=_with_rtt(CHURN, rtt_dist=rtt_dist, rtt_mean=1.5))
    off = sim_pt.draw_dynamics(torch.Generator().manual_seed(3), base, 2, 40)
    dyn = sim_pt.draw_dynamics(torch.Generator().manual_seed(3), on, 2, 40)
    for k, v in off.items():
        assert torch.equal(dyn[k], v), k
    ref = sim_jax.draw_dynamics(jax.random.PRNGKey(0), sim_jax.ScenarioConfig(
        N=6, churn=sim_jax.ChurnConfig(**dataclasses.asdict(on.churn))), 40)
    assert set(dyn) == set(ref)
    for k in ("rtt_base", "rtt_jit", "ack_u", "ack_p_drop"):
        assert tuple(dyn[k].shape) == (2,) + tuple(np.shape(ref[k])), k
        assert dyn[k].dtype == torch.float32
    assert (dyn["ack_p_drop"] == np.float32(CHURN.drop_prob)).all()


def test_rtt_tables_match_reference_in_distribution():
    gen = torch.Generator().manual_seed(0)
    N, M = 12, 4096
    fixed = tr_pt.draw_rtt_tables(gen, sim_pt.ChurnConfig(rtt_dist="fixed", rtt_mean=2.0),
                                  1, N, 64)
    assert (fixed["rtt_base"] == 2.0).all() and (fixed["rtt_jit"] == 1.0).all()
    het = tr_pt.draw_rtt_tables(gen, sim_pt.ChurnConfig(rtt_dist="fixed", rtt_mean=2.0,
                                                        rtt_het=0.5), 1, 400, 4)
    assert het["rtt_base"].min() >= 1.0 and het["rtt_base"].max() <= 3.0
    for kw in (dict(rtt_dist="lognormal", rtt_mean=2.0, rtt_sigma=0.5),
               dict(rtt_dist="cell", rtt_mean=1.0, rtt_spike_prob=0.25, rtt_spike_scale=10.0)):
        port = tr_pt.draw_rtt_tables(gen, sim_pt.ChurnConfig(**kw), 1, N, M)["rtt_jit"].numpy()
        ref = np.asarray(tr_jax.draw_rtt_tables(jax.random.PRNGKey(1), sim_jax.ChurnConfig(**kw),
                                                N, M)["rtt_jit"])
        assert port.dtype == np.float32 and port.min() > 0.0
        se = np.sqrt(port.var() / port.size + ref.var() / ref.size)
        assert abs(port.mean() - ref.mean()) < 5 * se
        if kw["rtt_dist"] == "cell":
            assert set(np.unique(port)) == set(np.unique(ref)) == {1.0, 10.0}
        else:
            assert abs(port.mean() - 1.0) < 0.05  # unit-mean jitter
    u = tr_pt.draw_rtt_tables(gen, sim_pt.ChurnConfig(rtt_dist="cell"), 1, N, M)["ack_u"]
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.01


# ---------------------------------------------------------------------------
# The primitives, bit for bit against the reference
# ---------------------------------------------------------------------------

def test_observation_delay_matches_reference():
    rtt, u = torch.full((4,), 2.0), torch.tensor([0.01, 0.9, 0.04, 0.5])
    assert torch.equal(tr_pt.observation_delay(rtt, u, 0.05), torch.tensor([4.0, 2.0, 4.0, 2.0]))
    ge = (0.0, 0.0, torch.tensor(0.0), torch.tensor(0.9))
    d = tr_pt.observation_delay(rtt, u, 0.05, ge_bad=torch.tensor([True, True, False, False]),
                                ge_params=ge)
    assert torch.equal(d, torch.tensor([4.0, 4.0, 4.0, 2.0]))
    assert torch.equal(tr_pt.observation_delay(torch.zeros(4), u, 0.5), torch.zeros(4))
    # Random inputs, with uniforms placed at and beside the composed loss
    # probability, against the reference's jitted function.
    rng = np.random.default_rng(0)
    n = 4096
    fb = rng.uniform(0, 5, n).astype(np.float32)
    bad = rng.random(n) < 0.5
    gp = np.array([0.03, 0.25, 0.013, 0.5], np.float32)
    p = np.float32(0.05)
    l_state = np.where(bad, gp[3], gp[2]).astype(np.float32)
    p_ack = np.float32(p + l_state - np.float64(p) * l_state)
    ack_u = np.where(rng.random(n) < 0.5, rng.random(n),
                     np.nextafter(p_ack, rng.choice([0.0, 1.0], n))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda *x: tr_jax.observation_delay(*x, jnp.asarray(gp)))(
        fb, ack_u, p, bad))
    port = tr_pt.observation_delay(torch.tensor(fb), torch.tensor(ack_u), torch.tensor(p),
                                   torch.tensor(bad), torch.tensor(gp))
    assert np.array_equal(port.numpy(), ref)


def test_tfrc_send_interval_matches_reference_bitwise():
    """Including the rounding the reference's XLA CPU build gives it (the
    divisions by 3 and 8 folded into constants, two fused multiply-adds, a
    correctly rounded square root)."""
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.uniform(0, 1.2, 20000), [0.0, 1e-30, 0.5, 1.0]]).astype(np.float32)
    rtt = rng.uniform(0, 20, p.size).astype(np.float32)
    ref = np.asarray(jax.jit(tr_jax.tfrc_send_interval)(p, rtt))
    port = tr_pt.tfrc_send_interval(torch.tensor(p), torch.tensor(rtt))
    assert port.dtype == torch.float32 and np.array_equal(port.numpy(), ref)
    one = lambda p, r: float(tr_pt.tfrc_send_interval(torch.tensor([p]), torch.tensor([r])))  # noqa: E731
    assert one(0.0, 3.0) == 0.0 and 0.0 < one(0.01, 1.0) < one(0.1, 1.0)
    assert one(0.1, 2.0) == pytest.approx(2.0 * one(0.1, 1.0), rel=1e-6)


def test_loss_event_update_matches_reference():
    w = 0.5
    t, f = torch.tensor([True]), torch.tensor([False])
    p1, s1 = tr_pt.loss_event_update(torch.zeros(1), torch.full((1,), -torch.inf), t, f,
                                     torch.tensor([10.0]), torch.tensor([2.0]), w=w)
    assert float(p1) == 0.5 and float(s1) == 10.0
    p2, s2 = tr_pt.loss_event_update(p1, s1, t, f, torch.tensor([11.0]), torch.tensor([2.0]), w=w)
    assert float(p2) == float(p1) and float(s2) == 10.0  # inside one RTT: same event
    p3, s3 = tr_pt.loss_event_update(p2, s2, t, f, torch.tensor([13.0]), torch.tensor([2.0]), w=w)
    assert float(p3) > float(p2) and float(s3) == 13.0
    p4, _ = tr_pt.loss_event_update(p3, s3, f, t, torch.tensor([14.0]), torch.tensor([2.0]), w=w)
    assert 0.0 < float(p4) < float(p3)
    rng = np.random.default_rng(2)
    n = 20000
    args = (rng.uniform(0, 1, n).astype(np.float32), rng.uniform(0, 50, n).astype(np.float32),
            rng.random(n) < 0.5, rng.random(n) < 0.4, rng.uniform(0, 60, n).astype(np.float32),
            rng.uniform(0, 5, n).astype(np.float32))
    ref = jax.jit(lambda *x: tr_jax.loss_event_update(*x, w=0.1))(*args)
    port = tr_pt.loss_event_update(*(torch.tensor(x) for x in args), w=0.1)
    for a, b in zip(port, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# RTT=0 transparency and delayed observation, on the port's own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["static", "churn"])
@pytest.mark.parametrize("name", sorted(pol_pt.names()))
def test_rtt0_is_bit_for_bit_transport_off(name, path):
    """Transport on at rtt_mean=0 is the engine without it, bit for bit: on
    the static path (a neutral ChurnConfig carrying the transport line
    against churn=None, at the static horizon R+K, as the reference's
    golden replay through the transport loop runs) and under the churn mix."""
    base = sim_pt.ScenarioConfig(N=16, scenario=1, churn=None if path == "static" else CHURN)
    cfg1 = dataclasses.replace(base, churn=_with_rtt(base.churn or sim_pt.ChurnConfig(),
                                                     rtt_het=0.5))
    m = 63 if path == "static" else None
    r0, r1 = ENG.run(base, name, 4, 60, M_override=m), ENG.run(cfg1, name, 4, 60, M_override=m)
    assert r1.M == r0.M
    for f in SPINE_FIELDS:
        assert _same(r0[f], r1[f]), (name, f)


@pytest.mark.parametrize("rtt_dist", ["lognormal", "cell"])
@pytest.mark.parametrize("name", OPEN_LOOP)
def test_open_loop_policies_invariant_under_delay(name, rtt_dist):
    """Open-loop pacing never reads the observed feedback, so any RTT leaves
    the whole run bit for bit unchanged."""
    cfg0 = sim_pt.ScenarioConfig(N=16, scenario=1, churn=CHURN)
    cfg1 = dataclasses.replace(cfg0, churn=_with_rtt(CHURN, rtt_dist=rtt_dist, rtt_mean=2.0,
                                                     rtt_het=0.5))
    r0, r1 = ENG.run(cfg0, name, 4, 60), ENG.run(cfg1, name, 4, 60)
    for f in SPINE_FIELDS:
        assert _same(r0[f], r1[f]), (name, f)


def test_delay_slows_ccp_and_ground_truth_stays_physical():
    """ccp pays for late observations (a larger T in every rep, all
    certified) under fig_transport's burst regime, while the trace stays
    physical: a result still arrives at its computed instant.  (Under the
    churn mix above no rep certifies at R=100 even without transport, in
    the reference too: test_torch_transport_pinned.py.)"""
    burst = sim_pt.ChurnConfig(period=10.0, max_backoff=8.0, ge_p_bad=0.06, ge_p_good=0.25,
                               ge_loss_bad=0.9, rtt_dist="lognormal")
    cfg0 = sim_pt.ScenarioConfig(N=16, scenario=1, churn=burst)
    cfg1 = dataclasses.replace(cfg0, churn=dataclasses.replace(burst, rtt_mean=2.0))
    r0, r1 = ENG.run(cfg0, "ccp", 8, 100), ENG.run(cfg1, "ccp", 8, 100)
    assert bool(r0.valid.all()) and bool(r1.valid.all()) and bool((r1.T > r0.T).all())
    t = eng_pt.draw_tables(torch.Generator().manual_seed(2), cfg1, 2, 100, 64)
    assert bool((t.dyn["rtt_base"] == 2.0).all())
    c = cfg1.ccp_cfg(100)
    outs, _ = eng_pt.policy_stream(t.beta, t.d_up, t.d_ack, t.d_down, policy=pol_pt.get("ccp"),
                                   cfg_static=(c.Bx, c.Br, c.Back, c.alpha),
                                   churn_static=cfg1.churn.static_key(), dyn=t.dyn, a=t.a)
    got = torch.isfinite(outs["tr"])
    # tr - d_down - beta is the compute start: never before the uplink arrival
    start = outs["tr"] - t.d_down - outs["beta"]
    assert bool((start[got] >= outs["arrive"][got] - 1e-4).all())


def test_ack_loss_doubles_delay_under_pure_drop():
    ch = sim_pt.ChurnConfig(drop_prob=0.3, rtt_dist="fixed", rtt_mean=1.5)
    dyn = sim_pt.draw_dynamics(torch.Generator().manual_seed(7),
                               sim_pt.ScenarioConfig(N=8, churn=ch), 1, 64)
    d = tr_pt.observation_delay(dyn["rtt_base"][..., None] * dyn["rtt_jit"], dyn["ack_u"],
                                dyn["ack_p_drop"][:, None, None])
    assert set(torch.unique(d).tolist()) <= {1.5, 3.0}
    assert 0.2 < float((d == 3.0).float().mean()) < 0.4


# ---------------------------------------------------------------------------
# tfrc_ccp
# ---------------------------------------------------------------------------

def test_tfrc_registered_with_the_reference_knobs():
    from repro.core import policies as pol_jax

    p, ref = pol_pt.get("tfrc_ccp"), pol_jax.get("tfrc_ccp")
    assert isinstance(p, pol_pt.TFRCCCPPolicy) and p == pol_pt.get("tfrc_ccp") and hash(p) == hash(p)
    assert (p.loss_ewma, p.p_clip, p.outage_run, p.version) == (
        ref.loss_ewma, ref.p_clip, ref.outage_run, ref.version)


@pytest.mark.parametrize("rtt_mean", [0.0, 2.0])
def test_tfrc_equals_ccp_without_loss(rtt_mean):
    """No loss at all (slowdowns only): p_ev stays 0, the TFRC floor is tx
    itself and the backoff never engages, so tfrc_ccp is ccp bit for bit
    at any RTT (the reference holds this too; with outages it does not,
    test_torch_transport_pinned.py)."""
    ch = sim_pt.ChurnConfig(p_slow=0.2, rtt_dist="fixed", rtt_mean=rtt_mean)
    cfg = sim_pt.ScenarioConfig(N=12, scenario=1, churn=ch)
    a, b = ENG.run(cfg, "ccp", 4, 60), ENG.run(cfg, "tfrc_ccp", 4, 60)
    for f in SPINE_FIELDS:
        assert _same(a[f], b[f]), f
    assert bool((b.extras["p_ev"] == 0).all()) and bool((a.lost_frac == 0).all())


def test_tfrc_measures_loss_events():
    ch = sim_pt.ChurnConfig(period=10.0, ge_p_bad=0.08, ge_p_good=0.15, ge_loss_bad=0.95,
                            rtt_dist="fixed", rtt_mean=1.0, max_backoff=8.0)
    res = ENG.run(sim_pt.ScenarioConfig(N=12, scenario=1, churn=ch), "tfrc_ccp", 3, 80)
    p_ev = res.extras["p_ev"]
    assert p_ev.shape == (3, 12)
    assert float(p_ev.min()) >= 0.0 and 0.0 < float(p_ev.max()) <= 1.0
