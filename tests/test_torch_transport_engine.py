"""Port parity for the engine's transport feedback-delay line on the
reference's tables: the reference draws the helper and packet tables and
the churn and transport dynamics (``fold_in(key, 0xC0DE)``, whose
``fold_in(., 0x577)`` holds the transport tables), ``interop`` hands them
to the port, and every trace of the loop (tr, idle, tx, arrive, beta, lost,
backoff, tx_end, sym_id), the policy's summary (``tfrc_ccp``'s ``p_ev``
included) and the results extracted from the trace (T, valid, r_n,
max_backoff, lost_frac bit for bit; efficiency at rtol 1e-6, its sums run
in another order than XLA's) equal the reference's, for every registered
policy under the fixed, log-normal and cell RTT regimes on the churn mix.

The reference's results are its ``policy_stream`` followed by its
``_sim_one`` extraction.  Its compiled ``_sim_one`` is not used: XLA fuses
the estimator's multiply-adds differently there (ROADMAP queue 3), and the
port rounds as ``policy_stream`` does.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as eng_jax
from repro.core import policies as pol_jax
from repro.core import simulator as sim_jax
from repro_torch.core import engine as eng_pt

from test_torch_churn_engine import assert_bitwise, jax_tables, port_tables, pt_cfg

CHURN = sim_jax.ChurnConfig(period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05,
                            ge_p_bad=0.03, ge_p_good=0.25, ge_loss_bad=0.5,
                            p_cell=0.05, cell_frac=0.5, max_backoff=8.0)
REGIMES = {
    "fixed": dict(rtt_dist="fixed", rtt_mean=2.0, rtt_het=0.3),
    "lognormal": dict(rtt_dist="lognormal", rtt_mean=2.0, rtt_het=0.3),
    "cell": dict(rtt_dist="cell", rtt_mean=1.0, rtt_spike_prob=0.1),
}
STATS = ("T", "valid", "r_n", "max_backoff", "lost_frac")


def reference_run(cfg, policy, tabs, dyns, R):
    """Per rep: the reference's ``policy_stream`` on its tables, then the
    extraction of its ``_sim_one`` on that trace.  Returns the traces and
    summaries of each rep, and the results stacked over reps."""
    pol = pol_jax.get(policy)
    c = cfg.ccp_cfg(R)
    kk = R + cfg.K(R)
    traces, results = [], []
    for r in range(tabs["mu"].shape[0]):
        aux = pol.prepare(cfg, R, c, tabs["mu"][r], tabs["a"][r], tabs["rate"][r])
        outs, psum = eng_jax.policy_stream(
            tabs["beta"][r], tabs["d_up"][r], tabs["d_ack"][r], tabs["d_down"][r],
            policy=pol, cfg_static=(c.Bx, c.Br, c.Back, c.alpha),
            churn_static=cfg.churn.static_key(), dyn=dyns[r], a=tabs["a"][r], aux=aux)
        traces.append((outs, psum))
        t, valid = pol.finalize(outs, aux, cfg, R, kk, outs["tx_end"])
        mask = pol.packet_mask(aux, cfg.N, outs["tr"].shape[1])
        tr, idle, beta = outs["tr"], outs["idle"], outs["beta"]
        if mask is not None:
            tr, idle, beta = (jnp.where(mask, tr, jnp.inf), jnp.where(mask, idle, 0.0),
                              jnp.where(mask, beta, 0.0))
        n_sent = jnp.isfinite(outs["tx"]).sum(axis=1)
        m = outs["lost"].shape[1]
        results.append(dict(
            T=t, valid=valid, r_n=(jnp.isfinite(tr) & (tr <= t)).sum(axis=1),
            efficiency=sim_jax.efficiency_measured(tr, idle, beta, t),
            max_backoff=outs["backoff"].max(axis=1),
            lost_frac=outs["lost"].mean(axis=1) * (m / jnp.maximum(n_sent, 1))))
    return traces, {k: np.stack([np.asarray(x[k]) for x in results]) for k in results[0]}


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("policy", sorted(pol_jax.names()))
def test_transport_loop_matches_reference(policy, regime):
    cfg = sim_jax.ScenarioConfig(N=8, scenario=1,
                                 churn=dataclasses.replace(CHURN, **REGIMES[regime]))
    R, M = 48, 96
    tabs, dyns = jax_tables(cfg, sim_jax.batch_keys(2, seed0=3), R, M)
    assert {"rtt_base", "rtt_jit", "ack_u", "ack_p_drop"} <= set(dyns[0])
    t = port_tables(tabs, dyns)
    pol = eng_pt._as_policy(policy)
    c = cfg.ccp_cfg(R)
    out_t, sum_t = eng_pt.policy_stream(
        t.beta, t.d_up, t.d_ack, t.d_down, policy=pol, cfg_static=(c.Bx, c.Br, c.Back, c.alpha),
        churn_static=cfg.churn.static_key(), dyn=t.dyn, a=t.a,
        aux=pol.prepare(pt_cfg(cfg), R, c, t.mu, t.a, t.rate))
    traces, ref = reference_run(cfg, policy, tabs, dyns, R)
    for r, (out_j, sum_j) in enumerate(traces):
        assert set(out_t) == set(out_j) and set(sum_t) == set(sum_j)
        for k, vj in list(out_j.items()) + list(sum_j.items()):
            assert_bitwise((out_t[k] if k in out_t else sum_t[k])[r].numpy(), vj, k)
    res = eng_pt.simulate(t, pt_cfg(cfg), R, policy)
    for k in STATS:
        assert_bitwise(res[k].numpy(), ref[k], k)
    np.testing.assert_allclose(res["efficiency"].numpy(), ref["efficiency"], rtol=1e-6, atol=0)
    if policy == "tfrc_ccp":
        assert float(sum_t["p_ev"].max()) > 0.0  # the estimator saw loss events
