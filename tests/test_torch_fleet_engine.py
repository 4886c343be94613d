"""Port parity for the fleet loop on the reference's tables: the reference
draws a fleet rep as its ``engine._fleet_one`` does (helpers and per-task
packet tables from ``split(key)``, releases from ``fold_in(key, 0xF7EE)``,
the placement from ``fold_in(key, 0xAD31)``, the fleet dynamics from
``fold_in(key, 0xC0DE)``), ``interop.fleet_tables_from_numpy`` hands them to
the port, and every trace of the port's ``fleet_stream`` (tr, idle, tx,
arrive, beta, lost, backoff, queue_delay, contention, tx_end, busy_end,
sym_id) and the policy's summary equal the reference's bit for bit, for 2,
3 and 5 tenants under FIFO, priority and processor sharing, for ``ccp``
and ``hcmm``, static, and for five policies under churn.  The whole fleet
batch and the transport case are in ``test_torch_fleet_batch.py``.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax
import numpy as np
import pytest

from repro.core import fleet as fleet_jax
from repro.core import policies as pol_jax
from repro.core import simulator as sim_jax
from repro_torch import interop
from repro_torch.core import engine as eng_pt
from repro_torch.core import fleet as fleet_pt

from test_torch_churn_engine import assert_bitwise, pt_cfg

CHURN = sim_jax.ChurnConfig(period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05,
                            ge_p_bad=0.03, ge_p_good=0.25, ge_loss_bad=0.5,
                            p_cell=0.05, cell_frac=0.5, max_backoff=8.0)


def reference_fleet_tables(cfg, fc, keys, R, M):
    """The reference's fleet draws per rep, stacked over reps as numpy, and
    the per-rep fleet dynamics."""
    cols = {k: [] for k in ("mu", "a", "rate", "beta", "d_up", "d_ack", "d_down", "release",
                            "recruit", "prio")}
    dyns = []
    for key in keys:
        k_h, k_p = jax.random.split(key)
        mu, a, rate = sim_jax.draw_helpers(k_h, cfg)
        tabs = sim_jax.draw_packet_tables_fleet(k_p, cfg, mu, a, rate, fc.n_tasks, M, R)
        release = fleet_jax.draw_releases(jax.random.fold_in(key, 0xF7EE), fc)
        recruit, prio = fleet_jax.place(jax.random.fold_in(key, 0xAD31), fc, cfg, mu, a, rate)
        for k, v in zip(cols, (mu, a, rate) + tuple(tabs) + (release, recruit, prio)):
            cols[k].append(np.asarray(v))
        if cfg.churn is not None:
            dyn = sim_jax.draw_dynamics_fleet(jax.random.fold_in(key, 0xC0DE), cfg, M,
                                              fc.n_tasks)
            dyns.append({k: np.asarray(v) for k, v in dyn.items()})
    return {k: np.stack(v) for k, v in cols.items()}, dyns


def _streams(policy, cfg, fc, R, M, reps=2, seed0=4):
    tabs, dyns = reference_fleet_tables(cfg, fc, sim_jax.batch_keys(reps, seed0=seed0), R, M)
    t = interop.fleet_tables_from_numpy(**tabs, dyn=dyns or None, device="cpu")
    c = cfg.ccp_cfg(R)
    kw = dict(cfg_static=(c.Bx, c.Br, c.Back, c.alpha), fleet_static=fc.static_key(),
              churn_static=None if cfg.churn is None else cfg.churn.static_key())
    pol_t, pol_j = eng_pt._as_policy(policy), pol_jax.get(policy)
    per_task = pol_t.fleet_aux == "per_task"
    assert per_task == (pol_j.fleet_aux == "per_task")
    prep = pol_t.prepare_fleet if per_task else pol_t.prepare
    args = (t.mu, t.a, t.rate) + ((t.recruit,) if per_task else ())
    out_t, sum_t = fleet_pt.fleet_stream(
        t.beta, t.d_up, t.d_ack, t.d_down, t.release, t.recruit, t.prio, policy=pol_t,
        dyn=t.dyn, a=t.a, aux=prep(pt_cfg(cfg), R, c, *args), aux_task_axis=per_task, **kw)
    refs = []
    for r in range(reps):
        prep = pol_j.prepare_fleet if per_task else pol_j.prepare
        args = tuple(tabs[k][r] for k in (("mu", "a", "rate", "recruit") if per_task
                                          else ("mu", "a", "rate")))
        refs.append(fleet_jax.fleet_stream(
            tabs["beta"][r], tabs["d_up"][r], tabs["d_ack"][r], tabs["d_down"][r],
            tabs["release"][r], tabs["recruit"][r], tabs["prio"][r], policy=pol_j,
            dyn=dyns[r] if dyns else None, a=tabs["a"][r],
            aux=prep(cfg, R, c, *args), aux_task_axis=per_task, **kw))
    return out_t, sum_t, refs


CASES = ([(p, T, d, "static") for p in ("ccp", "hcmm") for T in (2, 3, 5)
          for d in fleet_jax.DISCIPLINES]
         + [("uncoded_mean", 5, "fifo", "churn"), ("ccp", 5, "ps", "churn"),
            ("hcmm", 3, "priority", "churn"), ("rateless_ccp", 3, "ps", "churn"),
            ("adaptive_rate_fb", 2, "fifo", "churn")])


@pytest.mark.parametrize("policy,T,discipline,path", CASES)
def test_fleet_stream_matches_reference(policy, T, discipline, path):
    cfg = sim_jax.ScenarioConfig(N=6, scenario=1, churn=CHURN if path == "churn" else None)
    block = policy in ("hcmm", "uncoded_mean")
    fc = fleet_jax.FleetConfig(n_tasks=T, discipline=discipline,
                               placement="striped" if block else "all",
                               helpers_per_task=3 if block else None)
    out_t, sum_t, refs = _streams(policy, cfg, fc, R=30, M=48)
    for r, (out_j, sum_j) in enumerate(refs):
        assert set(out_t) == set(out_j) and set(sum_t) == set(sum_j)
        for k, vj in list(out_j.items()) + list(sum_j.items()):
            assert_bitwise((out_t[k] if k in out_t else sum_t[k])[r].numpy(), vj, k)
    overlap = T * (3 if block else 6) > 6  # recruit sets share helpers
    assert (int(out_t["contention"].max()) >= 2) == overlap  # then peers did queue
