"""Port parity for the multi-tenant fleet (``Engine.run_fleet``,
``core/fleet/``) on the port's own draws: the equivalence spine (a 1-task
fleet with the whole pool is ``Engine.run`` bit for bit, for every
registered policy, static, under churn and under churn with transport),
the queue laws of ``serve_round`` (work conservation, single-job
reduction; bit for bit against the reference on random rounds), admission
and releases, validation, the contention observables, the fleet metrics
and ``FleetRunResult.summary()``.  Mirrors ``tests/test_fleet.py`` and
``tests/test_transport.py``'s fleet case; the shard cases at the
reference's configs are in ``test_torch_sharded.py``.  The traces on the reference's tables are in
``test_torch_fleet_engine.py``.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as eng_jax
from repro.core import fleet as fleet_jax
from repro_torch.core import engine as eng_pt
from repro_torch.core import fleet
from repro_torch.core import policies as pol_pt
from repro_torch.core import simulator as sim_pt
from repro_torch.core.policies.ccp import CCPPolicy

ENG = eng_pt.Engine(device="cpu")
SPINE_FIELDS = ("T", "efficiency", "r_n", "valid", "max_backoff", "lost_frac")
CHURN = sim_pt.ChurnConfig(period=5.0, p_down=0.15, p_slow=0.25, drop_prob=0.05,
                           ge_p_bad=0.03, ge_p_good=0.25, ge_loss_bad=0.5,
                           p_cell=0.05, cell_frac=0.5, max_backoff=8.0)
PATHS = {
    "static": None,
    "churn": CHURN,
    "churn+transport": dataclasses.replace(CHURN, rtt_dist="lognormal", rtt_mean=1.0,
                                           rtt_het=0.3),
}


def _same(a, b) -> bool:
    return torch.equal(a.nan_to_num(), b.nan_to_num()) and torch.equal(a.isnan(), b.isnan())


# ---------------------------------------------------------------------------
# The equivalence spine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", sorted(pol_pt.names()))
def test_fleet_of_one_is_engine_run(name, path):
    cfg = sim_pt.ScenarioConfig(N=8, scenario=1, churn=PATHS[path])
    single = ENG.run(cfg, name, 3, 40, seed=5)
    fl = ENG.run_fleet(cfg, name, 3, 40, seed=5)
    assert isinstance(fl, eng_pt.FleetRunResult) and fl.M == single.M
    for f in SPINE_FIELDS:
        assert fl[f].shape[:2] == (3, 1), f
        assert _same(single[f], fl[f][:, 0]), (name, path, f)
    assert torch.equal(fl.sojourn, fl.T) and float(fl.release.max()) == 0.0
    fair = fl.fairness[torch.isfinite(fl.fairness)]
    assert torch.allclose(fair, torch.ones_like(fair))


def test_draw_fleet_tables_task0_is_draw_tables():
    """Task 0 of a fleet draws what draw_tables draws from the same
    generator state; helper-state churn tables are shared, the per-packet
    draws are per tenant."""
    ch = PATHS["churn+transport"]
    cfg = sim_pt.ScenarioConfig(N=6, scenario=1, churn=ch)
    fc = fleet.FleetConfig(n_tasks=3, placement="random", helpers_per_task=2,
                           arrival="poisson", load=0.5)
    one = eng_pt.draw_tables(torch.Generator().manual_seed(9), cfg, 2, 30, 20)
    fl = eng_pt.draw_fleet_tables(torch.Generator().manual_seed(9), cfg, fc, 2, 30, 20)
    for f in ("mu", "a", "rate"):
        assert torch.equal(getattr(one, f), getattr(fl, f))
    for f in ("beta", "d_up", "d_ack", "d_down"):
        assert torch.equal(getattr(one, f), getattr(fl, f)[:, 0]), f
        assert not torch.equal(getattr(fl, f)[:, 0], getattr(fl, f)[:, 1])
    for k, v in one.dyn.items():
        if k in sim_pt.FLEET_PER_TASK:
            assert fl.dyn[k].shape == (2, 3) + v.shape[1:] and torch.equal(fl.dyn[k][:, 0], v), k
        else:
            assert torch.equal(fl.dyn[k], v), k
    assert fl.release.shape == (2, 3) and bool((fl.release[:, 0] == 0).all())
    assert fl.recruit.shape == (2, 3, 6) and bool((fl.recruit.sum(-1) == 2).all())


# ---------------------------------------------------------------------------
# Queue laws
# ---------------------------------------------------------------------------

def _random_round(seed, T, N):
    rng = np.random.default_rng(seed)
    arrive = rng.uniform(0.0, 10.0, (T, N)).astype(np.float32)
    active = rng.random((T, N)) < 0.7
    demand = np.where(active, rng.uniform(0.1, 3.0, (T, N)), 0.0).astype(np.float32)
    busy = rng.uniform(0.0, 8.0, (N,)).astype(np.float32)
    key = rng.uniform(0.0, 1.0, (T, N)).astype(np.float32)
    return arrive, demand, active, busy, key


@pytest.mark.parametrize("discipline", fleet.DISCIPLINES)
@pytest.mark.parametrize("seed,T", [(0, 1), (1, 3), (2, 5), (3, 8)])
def test_serve_round_laws_and_reference_bits(discipline, seed, T):
    """Work conservation, causality and the discipline's finish rule, and
    every output bit for bit the reference's on the same round (batched
    over a leading rep axis in the port)."""
    arrive, demand, active, busy, key = _random_round(seed, T, 6)
    out = fleet.serve_round(*(torch.tensor(x)[None] for x in (arrive, demand, active)),
                            torch.tensor(busy)[None], torch.tensor(key)[None], discipline)
    start, fin, idle, busy_end = (x[0].numpy() for x in out)
    ref = fleet_jax.serve_round(jnp.asarray(arrive), jnp.asarray(demand), jnp.asarray(active),
                                jnp.asarray(busy), jnp.asarray(key), discipline)
    for got, want in zip((start, fin, idle, busy_end), ref):
        assert np.array_equal(got, np.asarray(want))
    np.testing.assert_allclose(busy_end - busy, demand.sum(0) + idle.sum(0), rtol=1e-5)
    assert (start[~active] == 0).all() and (fin[~active] == 0).all() and (idle[~active] == 0).all()
    assert (start[active] >= arrive[active] - 1e-5).all()
    if discipline != "ps":
        np.testing.assert_allclose(fin[active], start[active] + demand[active], rtol=1e-6)
    else:
        assert (fin[active] >= start[active] + demand[active] - 1e-4).all()


@pytest.mark.parametrize("discipline", fleet.DISCIPLINES)
def test_serve_round_single_job_is_the_dedicated_recurrence(discipline):
    rng = np.random.default_rng(7)
    arrive = torch.tensor(rng.uniform(0, 5, (1, 1, 16)).astype(np.float32))
    demand = torch.tensor(rng.uniform(0.1, 2, (1, 1, 16)).astype(np.float32))
    busy = torch.tensor(rng.uniform(0, 5, (1, 16)).astype(np.float32))
    start, fin, idle, busy_end = fleet.serve_round(
        arrive, demand, torch.ones((1, 1, 16), dtype=torch.bool), busy, arrive, discipline)
    want = torch.maximum(arrive[:, 0], busy)
    assert torch.equal(start[:, 0], want) and torch.equal(fin[:, 0], want + demand[:, 0])
    assert torch.equal(idle[:, 0], torch.clamp_min(arrive[:, 0] - busy, 0.0))
    assert torch.equal(busy_end, want + demand[:, 0])


def test_priority_and_ps_orders():
    arrive = torch.tensor([[[0.0], [0.1]]])
    demand = torch.ones((1, 2, 1))
    active = torch.ones((1, 2, 1), dtype=torch.bool)
    busy = torch.tensor([[5.0]])
    s_f, *_ = fleet.serve_round(arrive, demand, active, busy, arrive, "fifo")
    s_p, *_ = fleet.serve_round(arrive, demand, active, busy, torch.tensor([[[1.0], [0.0]]]),
                                "priority")
    assert float(s_f[0, 0, 0]) < float(s_f[0, 1, 0]) and float(s_p[0, 1, 0]) < float(s_p[0, 0, 0])
    z = torch.zeros((1, 2, 1))
    _, fin, _, busy_end = fleet.serve_round(z, torch.full((1, 2, 1), 3.0), active,
                                            torch.zeros((1, 1)), z, "ps")
    assert torch.equal(fin, torch.full((1, 2, 1), 6.0)) and float(busy_end) == 6.0


# ---------------------------------------------------------------------------
# Admission, releases, validation
# ---------------------------------------------------------------------------

def test_placements():
    gen = torch.Generator().manual_seed(0)
    cfg = sim_pt.ScenarioConfig(N=12, scenario=1)
    ones = torch.ones((2, 12))
    recruit, prio = fleet.place(gen, fleet.FleetConfig(n_tasks=3, placement="striped",
                                                       helpers_per_task=4), cfg, ones, ones, ones)
    assert recruit.shape == (2, 3, 12) and bool((recruit.sum(-1) == 4).all())
    assert bool((recruit.sum(1) <= 1).all())  # disjoint: 3 * 4 <= 12
    assert torch.equal(prio, torch.arange(3.0).expand(2, 3))
    wrap, _ = fleet.place(gen, fleet.FleetConfig(n_tasks=4, placement="striped",
                                                 helpers_per_task=4), cfg, ones, ones, ones)
    assert bool((wrap.sum(1) == torch.tensor([2] * 4 + [1] * 8)).all())  # wraps into overlap
    mu = torch.tensor([[1.0, 10.0, 1.0, 20.0, 1.0, 1.0]])
    fast, _ = fleet.place(gen, fleet.FleetConfig(n_tasks=2, placement="fastest",
                                                 helpers_per_task=2),
                          sim_pt.ScenarioConfig(N=6), mu, torch.full((1, 6), 0.01), mu)
    assert torch.equal(fast[0, 0], fast[0, 1]) and set(fast[0, 0].nonzero()[:, 0].tolist()) == {1, 3}
    rnd, _ = fleet.place(gen, fleet.FleetConfig(n_tasks=4, placement="random",
                                                helpers_per_task=3),
                         sim_pt.ScenarioConfig(N=10), torch.ones((5, 10)), None, None)
    assert bool((rnd.sum(-1) == 3).all()) and not torch.equal(rnd[:, 0], rnd[:, 1])
    _, pr = fleet.place(gen, fleet.FleetConfig(n_tasks=2, priority=(3.0, 1.0)), cfg,
                        ones, ones, ones)
    assert torch.equal(pr, torch.tensor([[3.0, 1.0]] * 2))
    # the reference's striped and fastest masks on the same helpers
    r_ref, _ = fleet_jax.place(jax.random.PRNGKey(0), fleet_jax.FleetConfig(
        n_tasks=4, placement="striped", helpers_per_task=4), cfg, jnp.ones(12), None, None)
    assert np.array_equal(wrap[0].numpy(), np.asarray(r_ref))


def test_block_policies_reallocate_over_recruit_set():
    cfg = sim_pt.ScenarioConfig(N=12, scenario=1)
    mu, a, rate = sim_pt.draw_helpers(torch.Generator().manual_seed(3), cfg, 2)
    recruit = torch.stack([torch.arange(12) < 4, torch.arange(12) >= 8]).expand(2, 2, 12)
    for name in ("hcmm", "uncoded_mean", "uncoded_mu"):
        pol = pol_pt.get(name)
        assert pol.fleet_aux == "per_task"
        loads = pol.prepare_fleet(cfg, 100, cfg.ccp_cfg(100), mu, a, rate, recruit)["loads"]
        assert loads.shape == (2, 2, 12), name
        assert bool((loads[~recruit] == 0).all()) and bool((loads.sum(-1) >= 100).all()), name
        one = pol.prepare(cfg, 100, cfg.ccp_cfg(100), torch.where(recruit[:, 1], mu, 0.0), a, rate)
        assert torch.equal(one["loads"], loads[:, 1])  # one prepare per tenant
    assert pol_pt.get("ccp").fleet_aux == "shared"
    res = ENG.run_fleet(cfg, "hcmm", 2, 120, fleet=fleet.FleetConfig(
        n_tasks=3, placement="striped", helpers_per_task=4))
    assert bool(res.valid.all()) and bool(torch.isfinite(res.sojourn).all())
    assert res.extras["loads"].shape == (2, 3, 12)


def test_register_placement_round_trips():
    @fleet.register_placement("_test_rule")
    def _rule(gen, fc, cfg, mu, a, rate):
        return torch.ones((mu.shape[0], fc.n_tasks, cfg.N), dtype=torch.bool)

    try:
        cfg = sim_pt.ScenarioConfig(N=4, scenario=1)
        recruit, _ = fleet.place(torch.Generator(), fleet.FleetConfig(
            n_tasks=2, placement="_test_rule"), cfg, torch.ones((1, 4)), None, None)
        assert bool(recruit.all())
        assert ENG.run_fleet(cfg, "ccp", 2, 20, fleet=fleet.FleetConfig(
            n_tasks=2, placement="_test_rule")).T.shape == (2, 2)
    finally:
        del fleet.PLACEMENTS["_test_rule"]


def test_release_processes():
    gen = torch.Generator().manual_seed(0)
    assert bool((fleet.draw_releases(gen, fleet.FleetConfig(n_tasks=4), 2) == 0).all())
    uni = fleet.draw_releases(gen, fleet.FleetConfig(n_tasks=4, arrival="uniform", load=2.0), 2)
    assert torch.equal(uni, torch.tensor([[0.0, 0.5, 1.0, 1.5]] * 2))
    ref = fleet_jax.draw_releases(jax.random.PRNGKey(0), fleet_jax.FleetConfig(
        n_tasks=4, arrival="uniform", load=3.0))
    got = fleet.draw_releases(gen, fleet.FleetConfig(n_tasks=4, arrival="uniform", load=3.0), 1)
    assert np.array_equal(got[0].numpy(), np.asarray(ref))
    poi = fleet.draw_releases(gen, fleet.FleetConfig(n_tasks=5, arrival="poisson", load=1.0), 3)
    assert bool((poi[:, 0] == 0).all()) and bool((poi.diff(dim=-1) > 0).all())
    many = fleet.draw_releases(gen, fleet.FleetConfig(n_tasks=2, arrival="poisson", load=2.0),
                               20000)[:, 1]
    assert abs(float(many.mean()) - 0.5) < 0.02  # exponential gaps at rate 2


@pytest.mark.parametrize("kw,match", [
    (dict(discipline="lifo"), "discipline"), (dict(arrival="bursty"), "arrival"),
    (dict(arrival="poisson"), "load"), (dict(n_tasks=0), "n_tasks"),
    (dict(n_tasks=2, priority=(1.0,)), "priority"), (dict(helpers_per_task=0), "helpers_per_task"),
])
def test_fleet_config_validation_matches_reference(kw, match):
    for mod in (fleet, fleet_jax):
        with pytest.raises(ValueError, match=match):
            mod.FleetConfig(**kw)
    assert fleet.FleetConfig(n_tasks=3, discipline="ps").static_key() == "ps"
    assert fleet.ARRIVALS == fleet_jax.ARRIVALS and fleet.DISCIPLINES == fleet_jax.DISCIPLINES
    assert set(fleet.PLACEMENTS) >= set(fleet_jax.PLACEMENTS)


def test_run_fleet_validation(monkeypatch):
    cfg = sim_pt.ScenarioConfig(N=4, scenario=1)
    with pytest.raises(TypeError, match="FleetConfig"):
        ENG.run_fleet(cfg, "ccp", 2, 10, fleet={"n_tasks": 2})
    with pytest.raises(ValueError) as e:
        ENG.run_fleet(cfg, "ccp", 2, 10, fleet=fleet.FleetConfig(n_tasks=2, placement="nearest"))
    assert all(w in str(e.value) for w in ("nearest", "striped", "register"))
    with pytest.raises(ValueError, match="helpers_per_task"):
        ENG.run_fleet(cfg, "ccp", 2, 10, fleet=fleet.FleetConfig(n_tasks=2, helpers_per_task=9))
    with pytest.raises(ValueError, match="R must be"):
        ENG.run_fleet(cfg, "ccp", 2, 0)
    with pytest.raises(ValueError, match="reps"):
        ENG.run_fleet(cfg, "ccp", 0, 10)
    with pytest.raises(ValueError, match="ccp"):
        ENG.run_fleet(cfg, "cpp", 2, 10)
    with pytest.raises(ValueError, match="discipline"):
        z = torch.zeros((1, 1, 2))
        fleet.serve_round(z, z, z > 0, torch.zeros((1, 2)), z, "lifo")
    # shard=True runs (since slice C5a): the reps split over the devices
    # given, every tenant of a rep on its device, bitwise the unsharded run;
    # a data mesh of more distinct cards than the host has raises.
    fc = fleet.FleetConfig(n_tasks=2)
    sharded = eng_pt.Engine(device="cpu", shard=True, devices=["cpu"] * 2).run_fleet(
        cfg, "ccp", 3, 10, fleet=fc)
    assert torch.equal(sharded.T, ENG.run_fleet(cfg, "ccp", 3, 10, fleet=fc).T)
    from repro_torch.launch import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 distinct devices"):
        mesh.make_host_mesh(data=2)


# ---------------------------------------------------------------------------
# Contention observables, metrics, behaviour under load
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _ProbeCCP(CCPPolicy):
    """ccp that folds StepCtx.queue_delay / contention into its state."""

    name = "_probe_ccp"

    def init(self, shape, device):
        return dict(super().init(shape, device), probe_qd=torch.zeros(shape),
                    probe_ct=torch.zeros(shape))

    def on_computed(self, state, ctx):
        state = super().on_computed(state, ctx)
        qd = ctx.queue_delay if ctx.queue_delay is not None else 0.0
        ct = ctx.contention if ctx.contention is not None else 0.0
        return dict(state, probe_qd=torch.maximum(state["probe_qd"], torch.as_tensor(qd)),
                    probe_ct=torch.maximum(state["probe_ct"], torch.as_tensor(ct).float()))

    def summary(self, state):
        return dict(probe_qd=state["probe_qd"], probe_ct=state["probe_ct"])


def test_fleet_exposes_queue_delay_and_contention_to_hooks():
    cfg = sim_pt.ScenarioConfig(N=6, scenario=1)
    res = ENG.run_fleet(cfg, _ProbeCCP(), 2, 30, fleet=fleet.FleetConfig(n_tasks=3))
    assert res.extras["probe_ct"].shape == (2, 3, 6)
    assert float(res.extras["probe_ct"].max()) >= 2 and float(res.extras["probe_qd"].max()) > 0
    single = ENG.run(cfg, _ProbeCCP(), 2, 30)
    assert float(single.extras["probe_qd"].max()) == 0


def test_contention_degrades_completion_and_metrics_ranges():
    cfg = sim_pt.ScenarioConfig(N=6, scenario=1)
    lone = ENG.run_fleet(cfg, "ccp", 3, 40)
    packed = ENG.run_fleet(cfg, "ccp", 3, 40, fleet=fleet.FleetConfig(n_tasks=4))
    assert packed.summary()["p50"] > lone.summary()["p50"] * 1.2
    assert float(np.nanmean(packed.fairness.numpy())) > 0.5
    res = ENG.run_fleet(cfg, "ccp", 2, 30, fleet=fleet.FleetConfig(
        n_tasks=3, discipline="ps", placement="striped", helpers_per_task=3))
    assert (res.n_tasks, res.discipline, res.T.shape, res.util.shape) == (3, "ps", (2, 3), (2, 6))
    assert bool(((res.util >= 0) & (res.util <= 1 + 1e-5)).all())
    f = res.fairness[torch.isfinite(res.fairness)]
    assert bool(((f > 1 / 3 - 1e-6) & (f <= 1 + 1e-6)).all())
    s = res.summary()
    assert s["p99"] >= s["p50"] > 0 and s["invalid"] == 0


def test_metrics_and_summary_match_reference():
    rng = np.random.default_rng(4)
    x = rng.uniform(1, 9, (5, 4)).astype(np.float32)
    valid = rng.random((5, 4)) < 0.7
    valid[0] = False
    got = fleet.jain_fairness(torch.tensor(x), torch.tensor(valid)).numpy()
    # compiled, as the reference's fleet batch computes it (fused reductions)
    want = np.asarray(jax.jit(jax.vmap(fleet_jax.jain_fairness))(x, valid))
    assert np.array_equal(got, want, equal_nan=True) and np.isnan(got[0])
    tr = np.where(rng.random((2, 3, 4, 8)) < 0.8, rng.uniform(0, 10, (2, 3, 4, 8)), np.inf)
    beta, dn = rng.uniform(0.1, 1, tr.shape), rng.uniform(0, 0.1, tr.shape)
    t_end = np.array([6.0, 0.0], np.float32)
    args = [a.astype(np.float32) for a in (beta, tr, dn)]
    got = fleet.helper_utilization(*(torch.tensor(a) for a in args), torch.tensor(t_end)).numpy()
    want = np.stack([np.asarray(fleet_jax.helper_utilization(*(a[b] for a in args), t_end[b]))
                     for b in range(2)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # summary(): the reference's reduction of the same arrays
    cfg = sim_pt.ScenarioConfig(N=6, scenario=1)
    res = ENG.run_fleet(cfg, "ccp", 3, 30, fleet=fleet.FleetConfig(n_tasks=3))
    res.valid[1, 2] = False
    ref = eng_jax.FleetRunResult(**{f: getattr(res, f).numpy() for f in eng_pt._FLEET_FIELDS},
                                 extras={}, M=res.M, policy="ccp", n_tasks=3, discipline="fifo")
    assert res.summary() == ref.summary() and res.summary()["invalid"] == 1
