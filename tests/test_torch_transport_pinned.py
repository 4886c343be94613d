"""The port pinned to the reference's *actual* outputs where the
reference's own transport tests fail on this tree (``tests/test_transport.py``):

* ``test_tfrc_equals_ccp_at_zero_loss`` runs at ``p_down=0.1``: outages do
  lose packets, and ``tfrc_ccp``'s backoff engages only after
  ``outage_run`` consecutive losses, so its per-helper ``max_backoff``
  stops at 1, 2 or 4 where ``ccp``'s reaches 4 or 8 (T stays equal).
* ``test_delay_slows_feedback_policies_but_stays_certified``: under its
  churn mix at R=60 the run *without* transport leaves 3 of 4 reps
  uncertified at the horizon cap 4(R+K) = 252.
* ``test_golden_replay_through_transport_scan``: the goldens were drawn
  with JAX's earlier threefry mode; drawn so, they replay through the
  transport loop at ``rtt_mean=0``.

Each case runs at the horizon where the reference's ``Engine.run`` stops
doubling (``REF_M``), on the reference's tables.  The transport-off runs
are held to the reference's batch (``engine._sim_batch_jit``), the
transport runs to its ``policy_stream`` and ``_sim_one`` extraction
(``test_torch_transport_engine.reference_run``).
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest

from repro.core import engine as eng_jax
from repro.core import policies as pol_jax
from repro.core import simulator as sim_jax
from repro_torch.core import engine as eng_pt

from test_torch_churn_engine import assert_bitwise, jax_tables, port_tables, pt_cfg
from test_torch_transport_engine import STATS, reference_run

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "policy_equivalence.json").read_text())
CHURN = sim_jax.ChurnConfig(period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05,
                            ge_p_bad=0.03, ge_p_good=0.25, ge_loss_bad=0.5,
                            p_cell=0.05, cell_frac=0.5, max_backoff=8.0)
KEYS = sim_jax.batch_keys(4)


def _port(cfg, tabs, dyns, R, policy):
    return eng_pt.simulate(port_tables(tabs, dyns), pt_cfg(cfg), R, policy)


@pytest.mark.parametrize("rtt_mean,ref_m", [(0.0, 252), (2.0, 128)])
def test_tfrc_against_ccp_with_outages_pinned(rtt_mean, ref_m):
    ch = sim_jax.ChurnConfig(p_down=0.1, p_slow=0.2, rtt_dist="fixed", rtt_mean=rtt_mean)
    cfg = sim_jax.ScenarioConfig(N=12, scenario=1, churn=ch)
    R = 60
    tabs, dyns = jax_tables(cfg, KEYS, R, ref_m)
    got = {}
    for policy in ("ccp", "tfrc_ccp"):
        _, ref = reference_run(cfg, policy, tabs, dyns, R)
        assert ref["valid"].all() == (ref_m < 252) and ref["valid"].any()  # why doubling stopped
        res = _port(cfg, tabs, dyns, R, policy)
        for k in STATS:
            assert_bitwise(res[k].numpy(), ref[k], k)
        got[policy] = res
    assert np.array_equal(got["ccp"]["T"].numpy(), got["tfrc_ccp"]["T"].numpy())
    mb_ccp, mb_tfrc = got["ccp"]["max_backoff"].numpy(), got["tfrc_ccp"]["max_backoff"].numpy()
    assert (mb_tfrc <= mb_ccp).all() and (mb_tfrc < mb_ccp).any()
    assert (got["ccp"]["lost_frac"].numpy() > 0).any()  # not zero loss


@pytest.mark.parametrize("policy", ["ccp", "rateless_ccp"])
def test_churn_mix_at_r60_pinned(policy):
    """Without transport the reference certifies 1 rep of 4 at the cap
    (M=252); with log-normal RTT 2.0 it stops at M=128, all certified."""
    R = 60
    cfg0 = sim_jax.ScenarioConfig(N=16, scenario=1, churn=CHURN)
    cfg1 = dataclasses.replace(cfg0, churn=dataclasses.replace(
        CHURN, rtt_dist="lognormal", rtt_mean=2.0))
    tabs, dyns = jax_tables(cfg0, KEYS, R, 252)
    ref0 = eng_jax._sim_batch_jit(KEYS, cfg0, R, 252, pol_jax.get(policy))
    assert np.array_equal(np.asarray(ref0["valid"]), [False, False, False, True])
    res0 = _port(cfg0, tabs, dyns, R, policy)
    for k in STATS:
        assert_bitwise(res0[k].numpy(), ref0[k], k)
    tabs, dyns = jax_tables(cfg1, KEYS, R, 128)
    _, ref1 = reference_run(cfg1, policy, tabs, dyns, R)
    assert ref1["valid"].all()
    res1 = _port(cfg1, tabs, dyns, R, policy)
    for k in STATS:
        assert_bitwise(res1[k].numpy(), ref1[k], k)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_goldens_through_the_transport_loop(name):
    """The eight goldens, drawn in the old threefry mode, through the
    port's transport loop at rtt_mean=0 (a neutral ChurnConfig with the
    transport line for the static goldens): T and efficiency at rtol 1e-6,
    r_n and valid exactly, as the port's golden replays compare."""
    g = GOLDEN[name]
    if name.startswith("static"):
        cfg = sim_jax.ScenarioConfig(N=20, scenario=2 if "sc2" in name else 1)
        ch, policy = sim_jax.ChurnConfig(), name.split("_")[-1]
    else:
        ch = sim_jax.ChurnConfig(period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05,
                                 ge_p_bad=0.02, ge_p_good=0.2, ge_loss_bad=0.5, p_cell=0.1,
                                 cell_frac=0.5, outage_dist="lognormal", outage_mean=4.0,
                                 outage_sigma=0.5, max_backoff=8.0)
        cfg, policy = sim_jax.ScenarioConfig(N=16, scenario=1), name[len("churn_"):]
    cfg = dataclasses.replace(cfg, churn=dataclasses.replace(ch, rtt_dist="fixed", rtt_mean=0.0))
    with jax.threefry_partitionable(False):
        tabs, dyns = jax_tables(
            cfg, sim_jax.batch_keys(g["reps"], seed0=g.get("seed0", 0)), g["R"], g["M"])
    assert (dyns[0]["rtt_base"] == 0).all()
    res = _port(cfg, tabs, dyns, g["R"], policy)
    np.testing.assert_allclose(res["T"].numpy(), np.float32(g["T"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(res["efficiency"].numpy(), np.float32(g["efficiency"]),
                               rtol=1e-6, atol=0)
    assert np.array_equal(res["r_n"].numpy(), np.asarray(g["r_n"]))
    assert np.array_equal(res["valid"].numpy(), np.asarray(g["valid"]))
