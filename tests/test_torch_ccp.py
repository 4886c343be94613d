"""Port parity for the CCP estimator (Algorithm 1) and the closed-form
theory: the same numpy inputs through ``repro.core.ccp`` and
``repro_torch.core.ccp`` agree within rtol 1e-6, ``inf``/``nan`` included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ccp as ccp_jax
from repro.core import theory as th_jax
from repro_torch.core import ccp as ccp_pt
from repro_torch.core import theory as th_pt

N = 257
FIELDS = ("rtt_data", "Tu", "m", "e_beta", "tti_backoff")


def _random_case(seed):
    rng = np.random.default_rng(seed)
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    state = dict(
        rtt_data=f32(rng.uniform(0.0, 0.05, N)),
        Tu=f32(rng.uniform(0.0, 2.0, N)),
        m=rng.integers(0, 5, N).astype(np.int32),  # m == 0: first packet
        e_beta=f32(rng.uniform(0.1, 2.0, N)),
        tti_backoff=f32(rng.choice([1.0, 2.0, 4.0, 8.0], N)),
    )
    tx = f32(rng.uniform(0.0, 10.0, N))
    tr = f32(tx + rng.uniform(0.0, 3.0, N))
    tr_prev = f32(tx - rng.uniform(-1.0, 1.0, N))
    rtt_ack = f32(rng.uniform(0.0, 0.02, N))
    # Non-finite inputs travel through where/maximum as in the reference.
    tr[:3] = np.inf
    tr_prev[3:6] = -np.inf
    rtt_ack[6:9] = np.nan
    active = rng.random(N) < 0.7
    return state, tx, tr, tr_prev, rtt_ack, active


def _close(t, j, name):
    np.testing.assert_allclose(t.numpy().astype(np.float64), np.asarray(j, np.float64),
                               rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("alpha", [0.25, 0.5])
def test_on_computed_matches_reference(seed, alpha):
    state, tx, tr, tr_prev, rtt_ack, active = _random_case(seed)
    cfg_j = ccp_jax.CCPConfig(Bx=8.0 * 1000, alpha=alpha)
    cfg_t = ccp_pt.CCPConfig(Bx=8.0 * 1000, alpha=alpha)
    assert dataclass_values(cfg_j) == dataclass_values(cfg_t)
    sj, tti_j = ccp_jax.on_computed(
        ccp_jax.CCPState(**{k: jnp.asarray(v) for k, v in state.items()}), cfg_j,
        jnp.asarray(tx), jnp.asarray(tr), jnp.asarray(tr_prev), jnp.asarray(rtt_ack),
        jnp.asarray(active))
    st, tti_t = ccp_pt.on_computed(
        ccp_pt.CCPState(**{k: torch.as_tensor(v) for k, v in state.items()}), cfg_t,
        torch.as_tensor(tx), torch.as_tensor(tr), torch.as_tensor(tr_prev),
        torch.as_tensor(rtt_ack), torch.as_tensor(active))
    for k in FIELDS:
        _close(getattr(st, k), getattr(sj, k), k)
    assert st.m.dtype == torch.int32
    _close(tti_t, tti_j, "tti")
    _close(ccp_pt.tti(st, torch.as_tensor(tr - tx)), ccp_jax.tti(sj, jnp.asarray(tr - tx)),
           "tti()")
    _close(ccp_pt.timeout_deadline(st, tti_t), ccp_jax.timeout_deadline(sj, tti_j),
           "timeout_deadline")


def dataclass_values(cfg):
    return (cfg.Bx, cfg.Br, cfg.Back, cfg.alpha, cfg.data_scale, cfg.back_frac,
            cfg.fwd_frac)


@pytest.mark.parametrize("max_backoff", [None, 8.0])
def test_on_timeout_and_arq_match_reference(max_backoff):
    state, *_rest, active = _random_case(3)
    sj = ccp_jax.on_timeout(
        ccp_jax.CCPState(**{k: jnp.asarray(v) for k, v in state.items()}),
        jnp.asarray(active), max_backoff=max_backoff)
    st = ccp_pt.on_timeout(
        ccp_pt.CCPState(**{k: torch.as_tensor(v) for k, v in state.items()}),
        torch.as_tensor(active), max_backoff=max_backoff)
    for k in FIELDS:
        _close(getattr(st, k), getattr(sj, k), k)
    _close(ccp_pt.arq_timeout(torch.as_tensor(state["e_beta"]),
                              torch.as_tensor(state["rtt_data"])),
           ccp_jax.arq_timeout(jnp.asarray(state["e_beta"]),
                               jnp.asarray(state["rtt_data"])), "arq_timeout")


def test_init_state_matches_reference():
    sj, st = ccp_jax.init_state(5), ccp_pt.init_state((2, 5))
    for k in FIELDS:
        assert np.array_equal(np.broadcast_to(np.asarray(getattr(sj, k)), (2, 5)),
                              getattr(st, k).numpy()), k


def test_theory_is_the_reference_copy():
    rng = np.random.default_rng(0)
    mu = rng.choice([1.0, 2.0, 4.0], 50)
    a = 1.0 / mu
    rtt = rng.uniform(0.0, 2.0, 50)
    for fn, args in [
        ("shifted_exp_mean", (a, mu)),
        ("expected_underutilization", (rtt, mu)),
        ("efficiency", (rtt, a, mu)),
        ("t_opt_model1", (2000, 100, a, mu)),
        ("t_opt_model2_realized", (2000, 100, a + 1.0 / mu)),
        ("t_opt_model2_upper", (2000, 100, a, mu)),
        ("optimal_allocation", (2000, 100, a + 1.0 / mu)),
        ("largest_remainder_round", (rng.uniform(0, 30, 50), 900)),
    ]:
        assert np.array_equal(getattr(th_pt, fn)(*args), getattr(th_jax, fn)(*args)), fn
