"""Port parity for the block baselines: the numpy allocation copies, the
batched in-loop ``uncoded_mean``/``uncoded_mu``/``hcmm`` policies on tables
that the JAX reference drew, the sequential reference path
(``core/baselines.py``), and the reference suite's own properties of both
(``tests/test_baselines.py``, the static block cases of
``tests/test_policies.py`` and ``test_system.py``'s headline), on the port.

Loads are compared bit for bit: the port sums in XLA's CPU order
(``policies.uncoded.ordered_sum``) and runs HCMM's Newton solve in float32
as the reference does.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import baselines as bl_jax
from repro.core import engine as eng_jax
from repro.core import policies as pol_jax
from repro.core import simulator as sim_jax
from repro.core.policies import hcmm as hcmm_jax
from repro.core.policies import uncoded as uncoded_jax
from repro_torch import interop
from repro_torch.configs.ccp_paper import FIG3
from repro_torch.core import baselines as bl_pt
from repro_torch.core import engine as eng_pt
from repro_torch.core import simulator as sim_pt
from repro_torch.core import theory
from repro_torch.core.policies import hcmm as hcmm_pt
from repro_torch.core.policies import uncoded as uncoded_pt
from test_torch_engine import _jax_tables, _pt_cfg

BLOCK = ["uncoded_mean", "uncoded_mu", "hcmm"]
ENG = eng_pt.Engine(device="cpu")
# Both of the paper's scenarios at N=20, and the one-class homogeneous case
# (tie-free allocation) of tests/test_policies.py at N=10.
CASES = {"sc1": sim_jax.ScenarioConfig(N=20, scenario=1),
         "sc2": sim_jax.ScenarioConfig(N=20, scenario=2),
         "homogeneous": sim_jax.ScenarioConfig(N=10, scenario=1, mu_choices=(2.0,))}


# ---------------------------------------------------------------------------
# The numpy copies and the batched allocations, against the reference
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(1, 40), R=st.integers(1, 10_000))
def test_numpy_allocations_equal_reference(seed, n, R):
    rng = np.random.default_rng(seed)
    mu = rng.choice([1.0, 2.0, 3.0, 4.0, 9.0], n) * rng.uniform(0.5, 1.5, n)
    a = rng.uniform(0.05, 2.0, n)
    for rule in ("mean", "mu"):
        assert np.array_equal(bl_pt.uncoded_allocation(R, mu, a, rule),
                              bl_jax.uncoded_allocation(R, mu, a, rule))
    assert np.array_equal(bl_pt.hcmm_loads(R, mu, a), bl_jax.hcmm_loads(R, mu, a))
    for mu_a in mu * a:
        assert bl_pt._hcmm_u_star(mu_a) == bl_jax._hcmm_u_star(mu_a)


@pytest.mark.parametrize("n", [1, 7, 20, 32, 33, 65, 100, 1025])
def test_ordered_sum_equals_xla_reduction(n):
    """The port's sum of a load vector equals XLA's CPU reduction bit for
    bit, batched and not, at every size a figure uses and beyond."""
    x = np.random.default_rng(n).uniform(-3.0, 3.0, (16, n)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: v.sum(axis=-1))(x))
    assert np.array_equal(uncoded_pt.ordered_sum(torch.as_tensor(x)).numpy(), ref)
    assert uncoded_pt.ordered_sum(torch.as_tensor(x[0])).item() == float(
        jax.jit(jnp.sum)(x[0]))


def _helpers(choices, a_mode, B, N, seed):
    rng = np.random.default_rng(seed)
    mu = rng.choice(choices, (B, N)).astype(np.float32)
    a = (np.float32(1.0) / mu if a_mode == "inv_mu" else np.full((B, N), 0.5)).astype(np.float32)
    return mu, a


@pytest.mark.parametrize("choices,a_mode", [((1.0, 2.0, 4.0), "const"),
                                            ((1.0, 3.0, 9.0), "inv_mu")])
@pytest.mark.parametrize("N", [20, 100])
@pytest.mark.parametrize("R", [400, 1500, 8000])
def test_batched_allocations_equal_reference(choices, a_mode, N, R):
    """The port's batched loads equal the reference's jitted policy
    ``prepare`` (uncoded) and ``hcmm_loads`` as int32, rep for rep."""
    mu, a = _helpers(choices, a_mode, 64, N, seed=N + R)
    mu_t, a_t = torch.as_tensor(mu), torch.as_tensor(a)
    for rule in ("mean", "mu"):
        ref = jax.jit(jax.vmap(lambda m, x, rule=rule: uncoded_jax.UncodedPolicy(rule=rule)
                               .prepare(None, R, None, m, x, None)["loads"]))(mu, a)
        got = uncoded_pt.UncodedPolicy(rule=rule).prepare(None, R, None, mu_t, a_t, None)["loads"]
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(ref)), rule
    ref = jax.jit(jax.vmap(lambda m, x: hcmm_jax.hcmm_loads(R, m, x)))(mu, a)
    got = hcmm_pt.hcmm_loads(R, mu_t, a_t)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(ref))
    u = jax.jit(hcmm_jax.u_star)(mu * a)
    assert np.array_equal(hcmm_pt.u_star(mu_t * a_t).numpy(), np.asarray(u))


def test_largest_remainder_round_breaks_ties_by_helper_index():
    """Equal fractional parts take the bump in helper order, as the
    reference's stable ``jnp.argsort`` gives them; ``total`` is per rep."""
    rng = np.random.default_rng(4)
    loads = (rng.integers(0, 9, (32, 12)) + rng.choice([0.25, 0.5, 0.75], (32, 12))
             ).astype(np.float32)
    total = np.ceil(loads.sum(axis=1)).astype(np.float32) + rng.integers(0, 3, 32)
    ref = jax.jit(jax.vmap(uncoded_jax.largest_remainder_round))(loads, total)
    got = uncoded_pt.largest_remainder_round(torch.as_tensor(loads), torch.as_tensor(total))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.sum(dim=1).numpy(), total.astype(np.int32))


# ---------------------------------------------------------------------------
# The engine route on reference-drawn tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", BLOCK)
@pytest.mark.parametrize("R", [400, 500])
@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_block_policy_matches_reference(case, R, policy):
    """The whole rep pipeline after the draw equals the reference's
    ``_sim_one``: T and efficiency at rtol 1e-6; valid, r_n and the loads
    exactly.  M=128 holds every block, so every rep certifies."""
    cfg, M = CASES[case], 128
    keys = sim_jax.batch_keys(3, seed0=R)
    tabs = _jax_tables(cfg, keys, R, M)
    res = eng_pt.simulate(interop.tables_from_numpy(**tabs, device="cpu"),
                          _pt_cfg(cfg), R, policy)
    ref = eng_jax._sim_batch_jit(keys, cfg, R, M, pol_jax.get(policy))
    assert set(res) == set(ref) and "x_loads" in res
    assert bool(res["valid"].all()) and res["x_loads"].dtype == torch.int32
    for k, vj in ref.items():
        vt, vj = res[k].numpy(), np.asarray(vj)
        if vj.dtype.kind in "bi":
            assert np.array_equal(vt, vj), k
        else:
            np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=0, err_msg=k)


def test_uncertified_block_rep_is_flagged_as_the_reference_does():
    """A horizon shorter than the largest block: the rep is invalid on both,
    with the same T, r_n and masked statistics."""
    cfg, R, M = CASES["sc1"], 500, 16
    keys = sim_jax.batch_keys(2, seed0=1)
    tabs = _jax_tables(cfg, keys, R, M)
    for policy in BLOCK:
        res = eng_pt.simulate(interop.tables_from_numpy(**tabs, device="cpu"),
                              _pt_cfg(cfg), R, policy)
        ref = eng_jax._sim_batch_jit(keys, cfg, R, M, pol_jax.get(policy))
        assert not bool(res["valid"].any())
        assert np.array_equal(res["valid"].numpy(), np.asarray(ref["valid"]))
        assert np.array_equal(res["r_n"].numpy(), np.asarray(ref["r_n"]))
        np.testing.assert_allclose(res["T"].numpy(), np.asarray(ref["T"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# The sequential route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["mean", "mu", "hcmm"])
@pytest.mark.parametrize("scenario", [1, 2])
def test_sequential_block_finish_times_match_reference(scenario, rule):
    """The port's table-fed finish times equal the reference's
    ``_block_finish_times`` at the same ``M_override`` on its own draws."""
    cfg, R, M = sim_jax.ScenarioConfig(N=20, scenario=scenario), 500, 64
    k_h, k_p = jax.random.split(jax.random.PRNGKey(scenario + 10))
    mu, a, rate = sim_jax.draw_helpers(k_h, cfg)
    mu_np, a_np = np.asarray(mu), np.asarray(a)
    loads = (bl_pt.hcmm_loads(R, mu_np, a_np) if rule == "hcmm"
             else bl_pt.uncoded_allocation(R, mu_np, a_np, rule))
    ref = bl_jax._block_finish_times(cfg, k_p, R, loads, mu, a, rate, M_override=M)
    beta, d_up, _d_ack, d_down = (np.array(t) for t in sim_jax.draw_packet_tables(
        k_p, cfg, mu, a, rate, M, R))
    got = bl_pt.block_finish_times(torch.as_tensor(beta), torch.as_tensor(d_up),
                                   torch.as_tensor(d_down), loads)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The reference suite's properties, on the port (tests/test_baselines.py)
# ---------------------------------------------------------------------------

def test_uncoded_allocation_sums_to_R():
    mu = np.array([1.0, 2.0, 4.0, 1.0])
    a = np.full(4, 0.5)
    for rule in ("mean", "mu"):
        r = bl_pt.uncoded_allocation(1000, mu, a, rule)
        assert r.sum() == 1000
        assert np.all(r >= 0)


def test_uncoded_mean_rule_inverse_to_mean():
    r = bl_pt.uncoded_allocation(900, np.array([1.0, 4.0]), np.array([0.5, 0.5]), "mean")
    np.testing.assert_allclose(r, [300, 600])  # E[beta] = 1.5 vs 0.75 -> 1:2


def test_hcmm_u_star_solves_fixed_point():
    for mu_a in (0.1, 0.5, 1.0, 5.0):
        u = bl_pt._hcmm_u_star(mu_a)
        assert u > 0
        np.testing.assert_allclose(np.log1p(u + mu_a), u, atol=1e-8)
    # the batched float32 solve lands on the same root
    mu_a = torch.tensor([[0.1, 0.5, 1.0, 5.0]])
    np.testing.assert_allclose(hcmm_pt.u_star(mu_a)[0].numpy(),
                               [bl_pt._hcmm_u_star(float(v)) for v in mu_a[0]], rtol=1e-6)


def test_hcmm_loads_overprovision():
    """HCMM allocates > R in total (redundancy) and faster helpers more."""
    mu = np.array([1.0, 2.0, 4.0] * 10)
    a = np.full(30, 0.5)
    for loads in (bl_pt.hcmm_loads(2000, mu, a),
                  hcmm_pt.hcmm_loads(2000, torch.as_tensor(mu[None], dtype=torch.float32),
                                     torch.as_tensor(a[None], dtype=torch.float32))[0].numpy()):
        assert loads.sum() > 2000
        by_mu = [loads[mu == m].mean() for m in (1.0, 2.0, 4.0)]
        assert by_mu[0] < by_mu[1] < by_mu[2]


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 500), R=st.integers(100, 2000))
def test_property_hcmm_loads_positive_and_bounded(seed, R):
    rng = np.random.default_rng(seed)
    mu = rng.choice([1.0, 2.0, 4.0], 20)
    a = rng.choice([0.25, 0.5, 1.0], 20)
    loads = bl_pt.hcmm_loads(R, mu, a)
    assert np.all(loads >= 0)
    assert R <= loads.sum() <= 3 * R  # sane redundancy factor


def test_run_uncoded_and_hcmm_return_finite_T():
    cfg = sim_pt.ScenarioConfig(N=20, scenario=2)
    u = bl_pt.run_uncoded(cfg, 500, seed=0, device="cpu")
    h = bl_pt.run_hcmm(cfg, 500, seed=0, device="cpu")
    assert np.isfinite(u["T"]) and u["T"] > 0
    assert np.isfinite(h["T"]) and h["T"] > 0
    assert u["loads"].sum() == 500 and h["loads"].sum() >= 500
    # HCMM (straggler-tolerant) should not be slower than uncoded in Sc2
    assert h["T"] <= u["T"] * 1.2


# ---------------------------------------------------------------------------
# Block baselines through the engine == the sequential path
# (the static block cases of tests/test_policies.py)
# ---------------------------------------------------------------------------

def test_uncoded_engine_matches_sequential_per_rep_homogeneous():
    """One helper class: the allocation is tie-free (R/N each), so the
    engine and the sequential path see identical loads and, at a pinned
    horizon, identical draws (one rep per seed): T matches per rep."""
    cfg = sim_pt.ScenarioConfig(N=10, scenario=1, mu_choices=(2.0,))
    for seed in range(4):
        res = ENG.run(cfg, "uncoded_mean", 1, 500, seed=seed)
        assert bool(res.valid.all())
        assert torch.equal(res.extras["loads"], torch.full((1, 10), 50, dtype=torch.int32))
        seq = bl_pt.run_uncoded(cfg, 500, seed=seed, device="cpu", M_override=res.M)
        np.testing.assert_allclose(float(res.T[0]), seq["T"], rtol=1e-5)


@pytest.mark.parametrize("pol,ref", [
    ("uncoded_mean", lambda c, r, s: bl_pt.run_uncoded(c, r, "mean", seed=s, device="cpu")),
    ("uncoded_mu", lambda c, r, s: bl_pt.run_uncoded(c, r, "mu", seed=s, device="cpu")),
    ("hcmm", lambda c, r, s: bl_pt.run_hcmm(c, r, seed=s, device="cpu")),
])
def test_block_policies_allocations_match_sequential(pol, ref):
    """The batched float32 allocation reproduces the float64 numpy solver's
    loads up to tie order: the same multiset and per-class totals."""
    cfg = sim_pt.ScenarioConfig(N=20, scenario=1)
    for seed in range(3):
        res = ENG.run(cfg, pol, 1, 500, seed=seed)
        seq = ref(cfg, 500, seed)
        le, ln = res.extras["loads"][0].numpy(), seq["loads"]
        assert np.array_equal(res.mu[0].numpy(), seq["mu"])
        np.testing.assert_array_equal(np.sort(le), np.sort(ln))
        for m in np.unique(seq["mu"]):
            assert le[seq["mu"] == m].sum() == ln[seq["mu"] == m].sum()


def test_hcmm_engine_matches_sequential_timing_given_loads():
    """Fix the loads to the engine's allocation and replay the sequential
    timing and completion rule on the engine's own tables: T matches."""
    cfg, R = sim_pt.ScenarioConfig(N=20, scenario=2), 400
    res = ENG.run(cfg, "hcmm", 3, R, seed=5)
    assert bool(res.valid.all())
    t = eng_pt.draw_tables(torch.Generator().manual_seed(5), cfg, 3, R, res.M)
    assert torch.equal(t.mu, res.mu)
    t_n = bl_pt.block_finish_times(t.beta, t.d_up, t.d_down, res.extras["loads"]).numpy()
    for r in range(3):
        loads = res.extras["loads"][r].numpy()
        order = np.argsort(t_n[r], kind="stable")
        pos = min(int(np.searchsorted(np.cumsum(loads[order]), R)), cfg.N - 1)
        np.testing.assert_allclose(float(res.T[r]), t_n[r][order][pos], rtol=1e-5)


def test_block_policies_mean_matches_sequential_path():
    """Distribution-level check (the horizons differ, so draws differ): the
    engine's means track the sequential baseline's."""
    cfg, reps = sim_pt.ScenarioConfig(N=20, scenario=1), 12
    for pol, ref in (("uncoded_mean", lambda s: bl_pt.run_uncoded(cfg, 400, seed=s, device="cpu")),
                     ("hcmm", lambda s: bl_pt.run_hcmm(cfg, 400, seed=s, device="cpu"))):
        res = ENG.run(cfg, pol, reps, 400, seed=0)
        t_seq = np.asarray([ref(s)["T"] for s in range(reps)])
        assert abs(float(res.T.mean()) / t_seq.mean() - 1) < 0.12, pol


def test_paper_headline_end_to_end():
    """tests/test_system.py's headline on the port's CPU route: CCP faster
    than uncoded and HCMM, and within 1.25x of eq. (27)."""
    cfg, R, reps = FIG3[1], 1500, 5
    t_ccp = np.mean([ENG.run_one(cfg, "ccp", R, seed=i)["T"] for i in range(reps)])
    t_unc = np.mean([bl_pt.run_uncoded(cfg, R, "mean", seed=i, device="cpu")["T"]
                     for i in range(reps)])
    t_hcmm = np.mean([bl_pt.run_hcmm(cfg, R, seed=i, device="cpu")["T"] for i in range(reps)])
    o = ENG.run_one(cfg, "ccp", R, seed=0)
    t_opt = theory.t_opt_model1(R, cfg.K(R), o["a"], o["mu"])
    assert t_ccp < t_unc and t_ccp < t_hcmm
    assert t_ccp < t_opt * 1.25
