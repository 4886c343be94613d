"""Port parity for coded gradient aggregation
(``repro_torch.core.gradient_coding``): the code, the parity assignments,
the decode weights and the weight tables equal the reference's
(``repro.core.gradient_coding``), and the reference's own tests
(``tests/test_gradient_coding.py``) hold on the port.

Tolerances: the tables are the same numpy code on the same LT code, so they
must be equal (decode weights to the last bit); recovered sums atol 1e-5,
the reference's."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import gradient_coding as gc_jax
from repro_torch.core import gradient_coding as gc

CODES = [(8, 4, 0), (8, 4, 1), (8, 4, 2), (4, 2, 3), (16, 4, 5), (6, 3, 11), (12, 1, 7)]


@pytest.mark.parametrize("R,K,seed", CODES)
def test_code_assignments_and_tables_equal_the_reference(R, K, seed):
    ours, ref = gc.make_gradient_code(R, K, seed=seed), gc_jax.make_gradient_code(R, K, seed=seed)
    for name in ("idx", "mask", "coef"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    assert (ours.R, ours.K) == (ref.R, ref.K)
    assert gc.parity_assignments(ours) == gc_jax.parity_assignments(ref)
    assert gc.expected_redundancy(ours) == gc_jax.expected_redundancy(ref)
    for lost in ([], [0], [R - 1], [1, R]):
        surv = np.setdiff1d(np.arange(R + K), lost)
        try:
            want = gc_jax.decode_weights(ref, surv)
        except ValueError:
            with pytest.raises(ValueError, match="cannot recover"):
                gc.decode_weights(ours, surv)
            continue
        got = gc.decode_weights(ours, surv)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    pats, ws = gc.weight_table(ours, max_stragglers=max(1, K // 2), seed=seed, n_patterns=16)
    pats_r, ws_r = gc_jax.weight_table(ref, max_stragglers=max(1, K // 2), seed=seed,
                                       n_patterns=16)
    np.testing.assert_array_equal(pats, pats_r)
    np.testing.assert_array_equal(ws, ws_r)


def test_parity_assignments_match_code():
    code = gc.make_gradient_code(8, 4, seed=0)
    assigns = gc.parity_assignments(code)
    assert len(assigns) == 4
    for k, nbrs in enumerate(assigns):
        row = code.R + k
        assert set(nbrs) == set(code.idx[row][code.mask[row]].tolist())
        assert len(nbrs) <= 4


def test_decode_weights_no_stragglers_is_systematic():
    code = gc.make_gradient_code(8, 4, seed=1)
    np.testing.assert_allclose(gc.decode_weights(code, np.arange(8)), np.ones(8), atol=1e-6)


def test_decode_weights_recover_sum_with_losses():
    code = gc.make_gradient_code(8, 4, seed=2)
    grads = np.random.default_rng(0).normal(size=(8, 5))
    coded = code.dense_generator() @ grads
    for lost in ([0], [3], [7, 2]):
        surv = np.setdiff1d(np.arange(12), lost)
        try:
            w = gc.decode_weights(code, surv)
        except ValueError:
            continue
        np.testing.assert_allclose(w @ coded[surv], grads.sum(0), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coded_grad_sum_on_tensors_matches_the_reference(dtype):
    code = gc.make_gradient_code(4, 2, seed=3)
    grads = np.random.default_rng(1).normal(size=(4, 3, 2))
    G = code.dense_generator()
    parities = np.einsum("kr,rab->kab", G[4:], grads)
    surv = [0, 2, 3, 4, 5]   # worker 1's systematic result lost
    wfull = np.zeros(6, np.float32)
    wfull[surv] = gc.decode_weights(code, surv)
    rec = gc.coded_grad_sum(torch.tensor(grads, dtype=dtype), torch.tensor(parities, dtype=dtype),
                            wfull)
    assert rec.dtype == dtype and rec.shape == (3, 2)
    np.testing.assert_allclose(rec.numpy(), grads.sum(0), atol=1e-5)
    ref = gc_jax.coded_grad_sum(jnp.asarray(grads, jnp.float32),
                                jnp.asarray(parities, jnp.float32), jnp.asarray(wfull))
    np.testing.assert_allclose(rec.float().numpy(), np.asarray(ref), atol=1e-5)


def test_weight_table_patterns_valid():
    code = gc.make_gradient_code(8, 4, seed=4)
    pats, ws = gc.weight_table(code, max_stragglers=2, seed=0, n_patterns=16)
    G = code.dense_generator()
    for pat, w in zip(pats, ws):
        np.testing.assert_allclose(w @ G, np.ones(8), atol=1e-5)
        assert np.all(w[~pat] == 0)


def test_expected_redundancy_bounded():
    r = gc.expected_redundancy(gc.make_gradient_code(16, 4, seed=5))
    assert 0 < r <= 4 * 4 / 16 + 1e-9


@settings(max_examples=20, deadline=None)
@given(R=st.integers(4, 16), K=st.integers(2, 6), seed=st.integers(0, 200))
def test_property_single_loss_always_recoverable(R, K, seed):
    from hypothesis import assume

    assume(K * 4 >= R)
    code = gc.make_gradient_code(R, K, seed=seed)
    lost = seed % R
    surv = np.setdiff1d(np.arange(R + K), [lost])
    w = gc.decode_weights(code, surv)
    np.testing.assert_allclose(w @ code.dense_generator()[surv], np.ones(R), atol=1e-5)
