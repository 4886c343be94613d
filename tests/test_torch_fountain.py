"""Port parity: the LT code construction, coded-matmul plans and peeling
plans of ``repro_torch`` equal the JAX reference's exactly, and the torch
encode/decode match the reference on the same numpy inputs."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_matmul as cm_jax
from repro.core import fountain as f_jax
from repro_torch import interop
from repro_torch.core import coded_matmul as cm_pt
from repro_torch.core import fountain as f_pt


def _same_code(a, b):
    assert (a.R, a.K) == (b.R, b.K)
    for field in ("idx", "mask", "coef"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert np.array_equal(a.weights, b.weights)


@pytest.mark.parametrize("R", [1, 2, 16, 100, 1000])
def test_degree_distributions_equal(R):
    assert np.array_equal(f_jax.ideal_soliton(R), f_pt.ideal_soliton(R))
    assert np.array_equal(f_jax.robust_soliton(R), f_pt.robust_soliton(R))


@pytest.mark.parametrize("kw", [
    dict(R=8, K=4, seed=1),
    dict(R=50, K=25, seed=3),
    dict(R=32, K=8, seed=0, parity_degree=16),
    dict(R=40, K=40, seed=5, d_max=3),
    dict(R=12, K=6, seed=2, coverage_min=0, systematic=False),
])
def test_make_lt_code_tables_equal(kw):
    _same_code(f_jax.make_lt_code(**kw), f_pt.make_lt_code(**kw))


def test_plan_coded_matmul_same_refusal():
    """Too little overhead to survive a shard loss: both refuse alike."""
    kw = dict(rows=256, n_shards=4, overhead=0.25, bm=16)
    with pytest.raises(ValueError) as ej:
        cm_jax.plan_coded_matmul(**kw)
    with pytest.raises(ValueError) as et:
        cm_pt.plan_coded_matmul(**kw)
    assert str(ej.value) == str(et.value)


@pytest.mark.parametrize("kw", [
    dict(rows=256, n_shards=4, overhead=0.5, bm=16),
    dict(rows=512, n_shards=4, overhead=0.5, bm=32, seed=3),
    dict(rows=8192, n_shards=8, overhead=0.25, bm=256),
])
def test_plan_coded_matmul_equal(kw):
    pj, pt = cm_jax.plan_coded_matmul(**kw), cm_pt.plan_coded_matmul(**kw)
    _same_code(pj.code, pt.code)
    assert np.array_equal(pj.placement, pt.placement)
    assert (pj.n_shards, pj.bm) == (pt.n_shards, pt.bm)
    # interop rebuilds the same plan from the reference's arrays
    c = pj.code
    pi = interop.plan_from_arrays(c.idx, c.mask, c.coef, c.R, c.K, pj.n_shards,
                                  pj.placement, pj.bm)
    _same_code(pi.code, pt.code)
    assert np.array_equal(pi.placement, pt.placement)


@pytest.mark.parametrize("R,K,n_lost,seed", [(16, 8, 0, 0), (16, 8, 4, 1),
                                             (40, 20, 10, 2), (64, 32, 20, 3)])
def test_peel_plans_and_rounds_equal(R, K, n_lost, seed):
    code = f_jax.make_lt_code(R, K, seed=seed)
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(R + K), rng.choice(R + K, n_lost, replace=False))
    pj = f_jax.peel_decode_plan(code, keep)
    pt = f_pt.peel_decode_plan(
        interop.lt_code_from_arrays(code.idx, code.mask, code.coef, R, K), keep)
    assert (pj is None) == (pt is None)
    if pj is None:
        return
    for field in ("direct_src", "direct_coded", "direct_coef", "order_coded",
                  "order_src", "order_pivot", "order_nbr_idx", "order_nbr_coef"):
        assert np.array_equal(getattr(pj, field), getattr(pt, field)), field
    rj, rt = f_jax.plan_rounds(pj), f_pt.plan_rounds(pt)
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        for field in ("coded", "src", "pivot", "nbr_idx", "nbr_coef"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), field


def test_decode_failure_prob_equal():
    assert (f_jax.decode_failure_prob(20, 10, 5, trials=20, seed=1)
            == f_pt.decode_failure_prob(20, 10, 5, trials=20, seed=1))


@pytest.mark.parametrize("R,K,n_lost,seed", [(16, 8, 0, 0), (16, 8, 3, 4),
                                             (12, 12, 8, 7)])
def test_encode_and_decode_match_reference(R, K, n_lost, seed):
    """encode/encode_ref/apply_decode_plan/decode on the same numpy blocks:
    equal method, values within float32 rounding (1e-5)."""
    code = f_jax.make_lt_code(R, K, seed=seed)
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((R, 4, 6)).astype(np.float32)
    enc_j = np.asarray(f_jax.encode(jnp.asarray(blocks), code))
    enc_t = f_pt.encode(torch.as_tensor(blocks), code).numpy()
    np.testing.assert_allclose(enc_t, enc_j, rtol=1e-6, atol=1e-6)
    keep = np.sort(rng.permutation(R + K)[: R + K - n_lost])
    dec_j, m_j = f_jax.decode(jnp.asarray(enc_j[keep]), code, keep)
    dec_t, m_t = f_pt.decode(torch.as_tensor(enc_j[keep]), code, keep)
    assert m_j == m_t
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dec_t.numpy(), blocks, rtol=1e-4, atol=1e-4)
