"""Port parity for the fleet's whole batch on the reference's tables:
``engine.simulate_fleet`` against the reference's fleet batch
(``engine._fleet_batch_jit``), every output bit for bit but efficiency and
utilization (rtol 1e-6: their sums run in another order than XLA's), under
each placement; and the transport case the port does not follow.

Under the transport line the reference's ``fleet_stream`` rounds CCP's RTT
estimate as its ``policy_stream`` does not (XLA fuses the EWMA's
multiply-add the other way in that program), so its 1-task fleet departs
from its own single-task loop; the port keeps the equivalence spine and
follows ``policy_stream`` (the last test pins this).
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses

import numpy as np
import pytest

from repro.core import engine as eng_jax
from repro.core import fleet as fleet_jax
from repro.core import policies as pol_jax
from repro.core import simulator as sim_jax
from repro_torch import interop
from repro_torch.core import engine as eng_pt
from repro_torch.core import fleet as fleet_pt

from test_torch_churn_engine import assert_bitwise, pt_cfg
from test_torch_fleet_engine import CHURN, _streams, reference_fleet_tables


@pytest.mark.parametrize("policy,T,discipline,path,placement", [
    ("ccp", 3, "fifo", "static", "striped"), ("ccp", 3, "ps", "churn", "all"),
    ("hcmm", 3, "priority", "churn", "striped"), ("rateless_ccp", 2, "fifo", "churn", "random"),
    ("naive", 4, "fifo", "static", "fastest")])
def test_simulate_fleet_matches_reference_batch(policy, T, discipline, path, placement):
    cfg = sim_jax.ScenarioConfig(N=6, scenario=1, churn=CHURN if path == "churn" else None)
    fc = fleet_jax.FleetConfig(n_tasks=T, discipline=discipline, placement=placement,
                               helpers_per_task=2 if placement == "fastest" else 4)
    keys = sim_jax.batch_keys(3, seed0=4)
    R, M = 30, 64
    tabs, dyns = reference_fleet_tables(cfg, fc, keys, R, M)
    res = eng_pt.simulate_fleet(interop.fleet_tables_from_numpy(**tabs, dyn=dyns or None,
                                                                device="cpu"),
                                pt_cfg(cfg), R, policy,
                                fleet_pt.FleetConfig(**dataclasses.asdict(fc)))
    ref = eng_jax._fleet_batch_jit(keys, cfg, R, M, pol_jax.get(policy), fc)
    assert set(res) == set(ref)
    for k, vj in ref.items():
        if k in ("efficiency", "util"):
            np.testing.assert_allclose(res[k].numpy(), np.asarray(vj), rtol=1e-6, atol=0)
        else:
            assert_bitwise(res[k].numpy(), vj, k)


def test_reference_fleet_departs_from_its_loop_under_transport():
    """One tenant with the whole pool under log-normal RTT: the port's
    fleet_stream equals the reference's policy_stream on the same task-0
    tables (the equivalence spine), while the reference's own fleet_stream
    differs from it by CCP's RTT estimate, ulps that move sends."""
    ch = dataclasses.replace(CHURN, rtt_dist="lognormal", rtt_mean=1.0, rtt_het=0.3)
    cfg = sim_jax.ScenarioConfig(N=6, scenario=1, churn=ch)
    fc = fleet_jax.FleetConfig(n_tasks=1)
    R, M = 30, 48
    out_t, _, refs = _streams("ccp", cfg, fc, R, M)
    tabs, dyns = reference_fleet_tables(cfg, fc, sim_jax.batch_keys(2, seed0=4), R, M)
    c = cfg.ccp_cfg(R)
    departed = 0
    for r, (out_f, _) in enumerate(refs):
        dyn0 = {k: (v[0] if k in ("drop", "ge_u_loss", "rtt_jit", "ack_u") else v)
                for k, v in dyns[r].items()}
        out_j, _ = eng_jax.policy_stream(
            tabs["beta"][r, 0], tabs["d_up"][r, 0], tabs["d_ack"][r, 0], tabs["d_down"][r, 0],
            policy=pol_jax.get("ccp"), cfg_static=(c.Bx, c.Br, c.Back, c.alpha),
            churn_static=ch.static_key(), dyn=dyn0, a=tabs["a"][r], aux={})
        for k in ("tr", "tx", "lost", "backoff"):
            assert_bitwise(out_t[k][r, 0].numpy(), out_j[k], k)
        departed += int((np.asarray(out_f["tx"])[0] != np.asarray(out_j["tx"])).sum())
    assert departed > 0
