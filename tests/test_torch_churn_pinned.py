"""``adaptive_rate_fb`` and ``rateless_ccp`` at the regime endpoints of
``benchmarks/fig_churn.SWEEPS`` (R=200, n=20, 8 reps), pinned to the
reference's actual outputs.

The reference's own property test there
(``test_decode.py::test_adaptive_fb_not_worse_than_fixed_k_rateless_on_churn_regimes``)
fails on this tree on its certified-reps count at the cell endpoint (the
horizon cap M = 4(R+K) = 840 certifies only a few reps), not on the ratio.
So the port is held to what the reference computes, rep for rep, not to
that property: at the horizon M where the reference's ``Engine.run``
stops doubling (``REF_M``: 840 = 4(R+K), its cap, where some rep stays
uncertified; 256 at the burst endpoint, where every rep certifies), the
reference's batch (``engine._sim_batch_jit``, what ``Engine.run``
returns) and the port's simulate on the tables and dynamics the
reference drew at that M give the same T, valid and r_n bit for bit.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import pytest
import numpy as np

from benchmarks import fig_churn
from repro.core import engine as eng_jax
from repro.core import policies as pol_jax
from repro.core import simulator as sim_jax
from repro_torch.core import engine as eng_pt

from test_torch_churn_engine import jax_tables, port_tables, pt_cfg

R, N, REPS = 200, 20, 8
REF_M = {"iid": 840, "burst": 256, "cell": 840}  # for both policies


@pytest.mark.parametrize("policy", ["rateless_ccp", "adaptive_rate_fb"])
@pytest.mark.parametrize("regime", sorted(fig_churn.SWEEPS))
def test_regime_endpoint_pinned_to_reference_outputs(regime, policy):
    axis, mk_cfg, _name = fig_churn.SWEEPS[regime]
    cfg = mk_cfg(axis[-1], N)
    keys = sim_jax.batch_keys(REPS)
    M = REF_M[regime]
    assert M <= eng_jax._m_cap(cfg, R + cfg.K(R), pol_jax.get(policy))
    ref = eng_jax._sim_batch_jit(keys, cfg, R, M, pol_jax.get(policy))
    valid = np.asarray(ref["valid"])
    assert valid.all() == (M < 840) and valid.any()  # why the doubling stopped here
    tabs, dyns = jax_tables(cfg, keys, R, M)
    res = eng_pt.simulate(port_tables(tabs, dyns), pt_cfg(cfg), R, policy)
    assert np.array_equal(res["valid"].numpy(), valid)
    assert np.array_equal(res["T"].numpy(), np.asarray(ref["T"]))
    assert np.array_equal(res["r_n"].numpy(), np.asarray(ref["r_n"]))
