"""Port parity for the data plane: ``run`` (every shard's coded products) and
``recover`` (y = A x from the survivors) against the JAX reference on the
same numpy inputs, with no loss and with each single shard lost, on a plan
whose losses peel and on one whose losses take the dense solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_matmul as cm_jax
from repro.core import fountain as f_jax
from repro_torch.core import coded_matmul as cm_pt

PLANS = {
    # R=16, K=8 dense ±1 parities of degree 8: every single-shard loss peels.
    "rows256-shards4": dict(rows=256, n_shards=4, overhead=0.5, bm=16),
    # A soliton code (the reference's default construction) placed
    # round-robin on 4 shards: losing shard 3 stalls the peeler and takes
    # the dense solve, the other losses peel.
    "soliton-dense": None,
}
METHODS = {"rows256-shards4": {"peel"}, "soliton-dense": {"peel", "dense"}}


def _plan(name):
    if PLANS[name] is not None:
        return (cm_jax.plan_coded_matmul(**PLANS[name]),
                cm_pt.plan_coded_matmul(**PLANS[name]))
    R, K, S = 16, 16, 4
    code = f_jax.make_lt_code(R, K, seed=5)
    ids = np.arange(R + K)
    placement = np.stack([ids[s::S] for s in range(S)])
    return (cm_jax.CodedMatmulPlan(code, S, placement, 8),
            cm_pt.CodedMatmulPlan(code, S, placement, 8))


def _method(plan, survivors):
    ids = plan.placement[survivors].reshape(-1)
    return "peel" if f_jax.peel_decode_plan(plan.code, ids) is not None else "dense"


@pytest.mark.parametrize("name", list(PLANS))
def test_run_and_recover_match_reference(name):
    pj, pt = _plan(name)
    rows = pj.code.R * pj.bm
    rng = np.random.default_rng(7)
    a = rng.standard_normal((rows, 40)).astype(np.float32)
    x = rng.standard_normal((40, 24)).astype(np.float32)
    out_j = cm_jax.run(pj, jnp.asarray(a), jnp.asarray(x))
    out_t = cm_pt.run(pt, torch.as_tensor(a), torch.as_tensor(x))
    out_j = np.array(out_j)
    assert out_t.shape == tuple(out_j.shape) == (pj.code.n_coded * pj.bm, 24)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-5, atol=1e-5)
    S = pj.n_shards
    methods = set()
    for survivors in [np.arange(S)] + [np.delete(np.arange(S), s) for s in range(S)]:
        methods.add(_method(pj, survivors))
        y_j = np.asarray(cm_jax.recover(pj, jnp.asarray(out_j), survivors))
        y_t = cm_pt.recover(pt, torch.as_tensor(out_j), survivors).numpy()
        scale = np.abs(a @ x).max()
        assert np.abs(y_t - y_j).max() <= 1e-4 * scale, survivors
        assert np.abs(y_t - a @ x).max() <= 1e-4 * scale, survivors
    assert methods == METHODS[name]


def test_device_blocks_are_the_float_weights():
    pj, pt = _plan("rows256-shards4")
    idx, w = cm_pt.device_blocks(pt, torch.zeros(1))
    idx_j, w_j = cm_jax.device_blocks(pj, None)
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    assert np.array_equal(idx.numpy(), np.asarray(idx_j))
    assert np.array_equal(w.numpy(), np.asarray(w_j))
    assert (w < 0).any()  # parity signs survive as coefficients
