"""Port parity for the fused coded matmul: the plain torch versions against
the JAX reference's plain versions and its Pallas kernel (interpret mode),
and the CPU dispatch.  The CUDA kernel itself is held against its plain
version in tests/test_torch_cuda.py (card only).

Tolerances are the reference suite's (tests/test_kernels_coded_matmul.py):
float32 1e-5, bfloat16 2e-2 (bf16 encodes round at different places in the
two frameworks).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import fountain as f_jax
from repro.kernels.coded_matmul import coded_matmul as cm_jax
from repro.kernels.coded_matmul import coded_matmul_ref as cm_ref_jax
from repro.kernels.coded_matmul.ref import lt_encode_ref as enc_ref_jax
from repro_torch.kernels.coded_matmul import (coded_matmul, coded_matmul_code,
                                              coded_matmul_cuda, coded_matmul_ref)
from repro_torch.kernels.coded_matmul.ops import flops
from repro_torch.kernels.coded_matmul.ref import lt_encode_ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SWEEP = [(4, 2, 8, 16, 16, 8, 8), (6, 3, 16, 64, 32, 16, 16),
         (8, 4, 8, 128, 128, 128, 128), (3, 2, 32, 48, 24, 16, 8),
         (10, 5, 8, 32, 8, 32, 8)]


def _inputs(R, K, bm, kdim, ndim, dtype, seed):
    """The same numpy inputs for both frameworks: values rounded to the
    working type once, so each side starts from identical numbers."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((R * bm, kdim)).astype(np.float32)
    x = rng.standard_normal((kdim, ndim)).astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    code = f_jax.make_lt_code(R=R, K=K, seed=R * 31 + K)
    return code, a, x


def _to_jax(v, dtype):
    return jnp.asarray(v).astype(JNP[dtype])


def _to_pt(v, dtype):
    return torch.as_tensor(v).to(PT[dtype])


def _close(out_t, ref_j, dtype, atol_mult=8):
    np.testing.assert_allclose(
        out_t.float().numpy(), np.asarray(ref_j, np.float32),
        rtol=TOL[dtype], atol=TOL[dtype] * atol_mult)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("operand", ["mask", "weights"])
@pytest.mark.parametrize("R,K,bm,kdim,ndim,bk,bn", SWEEP)
def test_plain_version_matches_reference_and_pallas(R, K, bm, kdim, ndim, bk, bn,
                                                    dtype, operand):
    code, a, x = _inputs(R, K, bm, kdim, ndim, dtype, seed=R + bm)
    m = code.mask if operand == "mask" else code.weights
    a_j, x_j = _to_jax(a, dtype), _to_jax(x, dtype)
    ref_j = cm_ref_jax(a_j, x_j, jnp.asarray(code.idx), jnp.asarray(m), bm)
    pallas = cm_jax(a_j, x_j, jnp.asarray(code.idx), jnp.asarray(m), bm=bm,
                    bk=bk, bn=bn, use_pallas=True, interpret=True)
    out = coded_matmul_ref(_to_pt(a, dtype), _to_pt(x, dtype),
                           torch.as_tensor(code.idx), torch.as_tensor(m), bm)
    assert out.shape == ((R + K) * bm, ndim) and out.dtype == PT[dtype]
    _close(out, ref_j, dtype)
    _close(out, pallas, dtype)


def test_ragged_shape_needs_no_padding():
    """Non-divisible k/n: the reference pads for Pallas; the port's result
    equals the padded Pallas path without padding."""
    code, a, x = _inputs(4, 2, 8, 20, 13, "float32", seed=2)
    idx, mask = jnp.asarray(code.idx), jnp.asarray(code.mask)
    pallas = cm_jax(jnp.asarray(a), jnp.asarray(x), idx, mask, bm=8, bk=16, bn=8,
                    use_pallas=True, interpret=True)
    out = coded_matmul(torch.as_tensor(a), torch.as_tensor(x),
                       torch.as_tensor(code.idx), torch.as_tensor(code.mask), bm=8)
    _close(out, pallas, "float32", atol_mult=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,K,bm,ncols", [(4, 2, 8, 16), (8, 4, 16, 128),
                                          (5, 3, 8, 24), (2, 1, 128, 256)])
def test_lt_encode_ref_matches_reference(R, K, bm, ncols, dtype):
    code, a, _ = _inputs(R, K, bm, ncols, 1, dtype, seed=R * 17 + K)
    for m in (code.mask, code.weights):
        ref_j = enc_ref_jax(_to_jax(a, dtype), jnp.asarray(code.idx),
                            jnp.asarray(m), bm)
        out = lt_encode_ref(_to_pt(a, dtype), torch.as_tensor(code.idx),
                            torch.as_tensor(m), bm)
        _close(out, ref_j, dtype, atol_mult=4)


def test_code_convenience_and_systematic_prefix():
    code, a, x = _inputs(5, 2, 16, 32, 16, "float32", seed=3)
    out = coded_matmul_code(torch.as_tensor(a), torch.as_tensor(x), code)
    ref = cm_ref_jax(jnp.asarray(a), jnp.asarray(x), jnp.asarray(code.idx),
                     jnp.asarray(code.weights), 16)
    _close(out, ref, "float32", atol_mult=1)
    np.testing.assert_allclose(out[: 5 * 16].numpy(), a @ x, rtol=1e-4, atol=1e-4)


def test_flops_equal_reference():
    from repro.kernels.coded_matmul.ops import flops as flops_jax
    assert flops(32, 8, 256, 4096, 4096, 3.5) == flops_jax(32, 8, 256, 4096, 4096, 3.5)


def test_cpu_dispatch_and_guards():
    """CPU tensors take the plain version; asking for the kernel on them,
    or handing the CUDA wrapper CPU tensors, raises."""
    code, a, x = _inputs(4, 2, 8, 16, 16, "float32", seed=4)
    args = (torch.as_tensor(a), torch.as_tensor(x), torch.as_tensor(code.idx),
            torch.as_tensor(code.weights))
    assert torch.equal(coded_matmul(*args, bm=8), coded_matmul_ref(*args, 8))
    assert torch.equal(coded_matmul(*args, bm=8, use_kernel=False),
                       coded_matmul_ref(*args, 8))
    with pytest.raises(ValueError, match="use_kernel"):
        coded_matmul(*args, bm=8, use_kernel=True)
    before = coded_matmul_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        coded_matmul_cuda(args[0], args[1], args[2].int(), args[3], 8)
    assert coded_matmul_cuda.launches == before
