"""Port parity for the standalone LT encode (K2): the port's entry
(``repro_torch.kernels.lt_encode``, which runs its plain version on CPU
tensors) against the JAX reference's Pallas kernel in interpret mode and
its plain version, on the same numpy inputs, and the CPU dispatch.  The
CUDA kernel itself is held against its plain version in
tests/test_torch_cuda.py (card only).

Tolerances are the reference suite's (tests/test_kernels_coded_matmul.py,
``test_lt_encode_sweep``): rtol float32 1e-5 / bfloat16 2e-2, atol four
times that (bf16 sums round at different places in the two frameworks).
Non-finite values are compared NaN-equal and inf-exact.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import decode as dec_jax
from repro.core import fountain as f_jax
from repro.kernels.coded_matmul.ref import lt_encode_ref as enc_ref_jax
from repro.kernels.lt_encode import lt_encode as enc_jax
from repro.kernels.lt_encode import lt_encode_code as enc_code_jax
from repro_torch.core import decode as dec_pt
from repro_torch.kernels.coded_matmul.ref import lt_encode_ref
from repro_torch.kernels.lt_encode import lt_encode, lt_encode_code, lt_encode_cuda

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The reference suite's sweep: (R, K, bm, ncols, bc).
SWEEP = [(4, 2, 8, 16, 8), (8, 4, 16, 128, 128), (5, 3, 8, 24, 8), (2, 1, 128, 256, 256)]


def _a(R, bm, ncols, dtype, seed):
    """Values rounded to the working type once, so both sides start equal."""
    a = np.random.default_rng(seed).standard_normal((R * bm, ncols)).astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _close(out_t, ref_j, dtype):
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(ref_j, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype] * 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,K,bm,ncols,bc", SWEEP)
def test_lt_encode_sweep_matches_pallas(R, K, bm, ncols, bc, dtype):
    code = f_jax.make_lt_code(R=R, K=K, seed=R * 17 + K)
    a = _a(R, bm, ncols, dtype, seed=R + K)
    idx, mask = jnp.asarray(code.idx), jnp.asarray(code.mask)
    pallas = enc_jax(jnp.asarray(a).astype(JNP[dtype]), idx, mask, bm=bm, bc=bc,
                     use_pallas=True, interpret=True)
    out = lt_encode(torch.as_tensor(a).to(PT[dtype]), torch.as_tensor(code.idx),
                    torch.as_tensor(code.mask), bm=bm)
    assert out.shape == ((R + K) * bm, ncols) and out.dtype == PT[dtype]
    _close(out, pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,K,bm,ncols", [(12, 10, 4, 24), (20, 24, 8, 16), (8, 8, 16, 40)])
def test_lt_encode_code_on_the_decoder_code_matches_pallas(R, K, bm, ncols, dtype):
    """The ±1 weights of the decoder's pool code (the rateless data plane's
    operand), against the reference's ``lt_encode_code`` through Pallas;
    ragged columns (40 with bc=8 pads in the reference, not in the port)."""
    code_j = dec_jax.make_decoder_code(R, K, seed=R + K, d_max=8)
    code_p = dec_pt.make_decoder_code(R, K, seed=R + K, d_max=8)
    a = _a(R, bm, ncols, dtype, seed=R)
    pallas = enc_code_jax(jnp.asarray(a).astype(JNP[dtype]), code_j, bm=bm, bc=8,
                          use_pallas=True, interpret=True)
    out = lt_encode_code(torch.as_tensor(a).to(PT[dtype]), code_p)
    _close(out, pallas, dtype)
    # the signs matter: the 0/1 mask gives other parity rows
    as_mask = lt_encode(torch.as_tensor(a).to(PT[dtype]), torch.as_tensor(code_p.idx),
                        torch.as_tensor(code_p.mask), bm=bm)
    assert not torch.equal(as_mask[R * bm:], out[R * bm:])


@pytest.mark.parametrize("where", ["padding", "neighbour"])
def test_plain_version_propagates_non_finite_as_the_reference(where):
    """An inf in source block 0, which parity rows reach through their
    padding slots (index 0, weight 0): 0 * inf makes NaN there, element by
    element, in both plain versions; a real neighbour carries the inf."""
    code = f_jax.make_lt_code(R=6, K=4, seed=1)
    a = _a(6, 8, 24, "float32", seed=7)
    blk = 0 if where == "padding" else int(code.idx[6, 0])
    a[blk * 8 + 3, 5] = np.inf
    a[blk * 8 + 6, 11] = np.nan
    for m in (code.mask, code.weights):
        ref_j = enc_ref_jax(jnp.asarray(a), jnp.asarray(code.idx), jnp.asarray(m), 8)
        out = lt_encode(torch.as_tensor(a), torch.as_tensor(code.idx), torch.as_tensor(m), bm=8)
        torch.testing.assert_close(out, torch.as_tensor(np.array(ref_j)), rtol=1e-5,
                                   atol=4e-5, equal_nan=True)
        assert bool(torch.isnan(out).any())


def test_cpu_dispatch_and_guards():
    """CPU tensors take the plain version; asking for the kernel on them,
    or handing the CUDA wrapper CPU tensors, raises and counts nothing."""
    code = f_jax.make_lt_code(R=4, K=2, seed=9)
    a = torch.as_tensor(_a(4, 8, 16, "float32", seed=1))
    idx, w = torch.as_tensor(code.idx), torch.as_tensor(code.weights)
    assert torch.equal(lt_encode(a, idx, w, bm=8), lt_encode_ref(a, idx, w, 8))
    assert torch.equal(lt_encode(a, idx, w, bm=8, use_kernel=False), lt_encode_ref(a, idx, w, 8))
    with pytest.raises(ValueError, match="use_kernel"):
        lt_encode(a, idx, w, bm=8, use_kernel=True)
    with pytest.raises(ValueError, match="divisible"):
        lt_encode(a, idx, w, bm=5)
    with pytest.raises(ValueError, match="divisible by R"):
        lt_encode_code(a[:30], code)
    before = lt_encode_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        lt_encode_cuda(a, idx.int(), w, 8)
    assert lt_encode_cuda.launches == before
