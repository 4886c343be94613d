"""Port parity for the round-based LT payload decode (K3): the port's
entry (``repro_torch.kernels.lt_decode``, which runs its plain version on
CPU tensors) against the JAX reference's Pallas kernel in interpret mode,
its plain version and the offline ``fountain.decode``, on the same numpy
inputs, and the CPU dispatch.  The CUDA kernel itself is held against its
plain version in tests/test_torch_cuda.py (card only).

Tolerances are the reference suite's (tests/test_decode.py,
``test_lt_decode_kernel_vs_ref_vs_offline``): kernel against plain version
1e-5 (rtol and atol), decode against the sources and the offline decode
1e-4; bfloat16 2e-2.  Non-finite values are compared NaN-equal.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import decode as dec_jax
from repro.core import fountain as f_jax
from repro.kernels.lt_decode import lt_decode as dec_payload_jax
from repro.kernels.lt_decode import peel_round_ref as peel_round_jax
from repro_torch.core import decode as dec_pt
from repro_torch.core import fountain as f_pt
from repro_torch.kernels.lt_decode import (lt_decode, lt_decode_code, lt_decode_ref,
                                           lt_decode_round_cuda, peel_round_ref)
from repro_torch.kernels.lt_encode import lt_encode_code

SHAPES = [(12, 10, 4, 24, 8, 3), (20, 24, 8, 16, 16, 6), (8, 8, 16, 40, 8, 2)]


def _round_trip_inputs(R, K, bm, cols, n_lost, dtype=np.float32):
    """The reference suite's round trip: encode random sources with the
    decoder's pool code, lose ``n_lost`` systematic blocks, keep the rest."""
    code = dec_pt.make_decoder_code(R, K, seed=R + K, d_max=8)
    x = np.random.default_rng(R).standard_normal((R * bm, cols)).astype(np.float32)
    if dtype != np.float32:
        x = x.astype(dtype).astype(np.float32)
    coded = lt_encode_code(torch.as_tensor(x), code, bm=bm).numpy()
    lost = np.random.default_rng(n_lost).choice(R, size=n_lost, replace=False)
    keep = np.setdiff1d(np.arange(R + K), lost)
    crx = coded.reshape(R + K, bm, cols)[keep].reshape(-1, cols)
    return code, x, keep, crx


@pytest.mark.parametrize("R,K,bm,cols,bc,n_lost", SHAPES)
def test_lt_decode_kernel_vs_ref_vs_offline(R, K, bm, cols, bc, n_lost):
    code, x, keep, crx = _round_trip_inputs(R, K, bm, cols, n_lost)
    plan = f_pt.peel_decode_plan(code, keep)
    assert plan is not None, "pool code must peel these small loss patterns"
    code_j = dec_jax.make_decoder_code(R, K, seed=R + K, d_max=8)
    plan_j = f_jax.peel_decode_plan(code_j, keep)
    pallas = dec_payload_jax(jnp.asarray(crx), plan_j, bm=bm, use_pallas=True,
                             interpret=True, bc=bc)
    ref_j = dec_payload_jax(jnp.asarray(crx), plan_j, bm=bm)
    out = lt_decode(torch.as_tensor(crx), plan, bm=bm)
    assert out.shape == (R * bm, cols) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), x, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_j), atol=1e-5, rtol=1e-5)
    off, method = f_pt.decode(torch.as_tensor(crx).reshape(len(keep), bm, cols), code, keep)
    assert method == "peel"
    np.testing.assert_allclose(off.reshape(-1, cols).numpy(), out.numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(lt_decode_code(torch.as_tensor(crx), code, keep), out)


def test_lt_decode_bf16_matches_reference():
    R, K, bm, cols, bc, n_lost = SHAPES[1]
    code, x, keep, crx = _round_trip_inputs(R, K, bm, cols, n_lost, ml_dtypes.bfloat16)
    crx = crx.astype(ml_dtypes.bfloat16).astype(np.float32)
    plan_j = f_jax.peel_decode_plan(dec_jax.make_decoder_code(R, K, seed=R + K, d_max=8), keep)
    pallas = dec_payload_jax(jnp.asarray(crx).astype(jnp.bfloat16), plan_j, bm=bm,
                             use_pallas=True, interpret=True, bc=bc)
    out = lt_decode_code(torch.as_tensor(crx).to(torch.bfloat16), code, keep)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(pallas, np.float32),
                               atol=2e-2 * 4, rtol=2e-2)


def test_peel_round_ref_equals_reference():
    R, K, bm, cols, _bc, n_lost = SHAPES[0]
    code, x, keep, crx = _round_trip_inputs(R, K, bm, cols, n_lost)
    plan = f_pt.peel_decode_plan(code, keep)
    rnd = f_pt.plan_rounds(plan)[0]
    src = np.random.default_rng(1).standard_normal((R, bm, cols)).astype(np.float32)
    coded = crx.reshape(-1, bm, cols)
    out = peel_round_ref(torch.as_tensor(src), torch.as_tensor(coded), rnd, bm=bm)
    want = peel_round_jax(jnp.asarray(src), jnp.asarray(coded), rnd, bm=bm)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_plain_version_propagates_non_finite_as_the_reference():
    """An inf in a received systematic block (source 0, which the plan's
    padding slots name): the decoded sources carry NaN where the reference's
    padding terms multiply it by 0, and inf where it is a real term."""
    R, K, bm, cols, _bc, _n_lost = SHAPES[1]
    code, x, _keep, _crx = _round_trip_inputs(R, K, bm, cols, 0)
    coded = lt_encode_code(torch.as_tensor(x), code, bm=bm).numpy()
    keep = np.setdiff1d(np.arange(R + K), [2, 5, 11, 17])  # source 0 arrives
    crx = coded.reshape(R + K, bm, cols)[keep].reshape(-1, cols)
    crx[2, 5] = np.inf  # the first received block is source 0: its row 2
    plan_j = f_jax.peel_decode_plan(dec_jax.make_decoder_code(R, K, seed=R + K, d_max=8), keep)
    assert plan_j is not None and (plan_j.order_nbr_coef == 0).any()
    ref_j = dec_payload_jax(jnp.asarray(crx), plan_j, bm=bm)
    out = lt_decode_code(torch.as_tensor(crx), code, keep)
    torch.testing.assert_close(out, torch.as_tensor(np.array(ref_j)), rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    assert bool(torch.isnan(out).any()) and bool(torch.isinf(out).any())


def test_lt_decode_code_raises_on_stall():
    code = f_pt.make_lt_code(R=8, K=0, seed=0)
    crx = torch.zeros((7 * 2, 4))
    keep = np.setdiff1d(np.arange(8), [3])
    with pytest.raises(ValueError, match="stalled"):
        lt_decode_code(crx, code, keep, bm=2)


def test_cpu_dispatch_and_guards():
    R, K, bm, cols, _bc, n_lost = SHAPES[0]
    code, x, keep, crx = _round_trip_inputs(R, K, bm, cols, n_lost)
    plan = f_pt.peel_decode_plan(code, keep)
    crx_t = torch.as_tensor(crx)
    assert torch.equal(lt_decode(crx_t, plan, bm=bm, use_kernel=False),
                       lt_decode_ref(crx_t, plan, bm=bm))
    with pytest.raises(ValueError, match="use_kernel"):
        lt_decode(crx_t, plan, bm=bm, use_kernel=True)
    with pytest.raises(ValueError, match="divisible"):
        lt_decode(crx_t[:-1], plan, bm=bm)
    rnd = f_pt.plan_rounds(plan)[0]
    i32 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.int32)  # noqa: E731
    before = lt_decode_round_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        lt_decode_round_cuda(crx_t, torch.zeros((R * bm, cols)), i32(rnd.coded), i32(rnd.src),
                             i32(rnd.nbr_idx), torch.as_tensor(rnd.nbr_coef),
                             torch.as_tensor(1.0 / rnd.pivot), bm)
    assert lt_decode_round_cuda.launches == before
