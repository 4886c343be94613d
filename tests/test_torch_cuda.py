"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA card and the CUDA toolkit; they are marked
``gpu`` and skip without a card.  The file imports nothing of JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerances are the reference suite's: float32 1e-5, bfloat16 2e-2, each
scaled by 1 + max|ref| (the kernel sums in another order than the plain
version, and a bf16 encode rounds in the plain version only).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fountain
from repro_torch.kernels.coded_matmul import (coded_matmul, coded_matmul_cuda,
                                              coded_matmul_ref)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# The reference suite's sweep shapes, a ragged k/n shape, several row tiles
# with dense parities of degree R/2 (16: every neighbour staged; 32: more
# neighbours than the float32 kernel stages), and ragged rows.
SHAPES = [(4, 2, 8, 16, 16), (6, 3, 16, 64, 32), (8, 4, 8, 128, 128),
          (3, 2, 32, 48, 24), (10, 5, 8, 32, 8), (4, 2, 8, 20, 13),
          (32, 8, 256, 300, 260), (64, 8, 16, 100, 72), (5, 3, 130, 77, 129)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["mask", "weights"])
@pytest.mark.parametrize("R,K,bm,kdim,ndim", SHAPES)
def test_cuda_kernel_matches_plain_version(card, R, K, bm, kdim, ndim, dtype, operand):
    code = fountain.make_lt_code(R=R, K=K, seed=R * 31 + K,
                                 parity_degree=R // 2 if R >= 32 else None)
    rng = np.random.default_rng(R + bm)
    a = torch.as_tensor(rng.standard_normal((R * bm, kdim)), dtype=dtype, device=card)
    x = torch.as_tensor(rng.standard_normal((kdim, ndim)), dtype=dtype, device=card)
    m = code.mask if operand == "mask" else code.weights
    idx, m = torch.as_tensor(code.idx, device=card), torch.as_tensor(m, device=card)
    before = coded_matmul_cuda.launches
    out = coded_matmul(a, x, idx, m, bm=bm)
    ref = coded_matmul_ref(a, x, idx, m, bm)
    torch.cuda.synchronize()
    assert coded_matmul_cuda.launches == before + 1
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = float((out.float() - ref.float()).abs().max())
    assert err <= TOL[dtype] * (1.0 + float(ref.float().abs().max()))


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(card):
    a = torch.zeros((16, 8), device=card)
    x = torch.zeros((8, 4), device=card)
    idx = torch.zeros((3, 2), dtype=torch.int32, device=card)
    w = torch.ones((3, 2), device=card)
    with pytest.raises(ValueError, match="int32"):
        coded_matmul_cuda(a, x, idx.long(), w, 8)
    with pytest.raises(ValueError, match="share one type"):
        coded_matmul_cuda(a, x.double(), idx, w, 8)
    with pytest.raises(ValueError, match="contiguous"):
        coded_matmul_cuda(a, x.t().contiguous().t(), idx, w, 8)
    with pytest.raises(ValueError, match="divisible"):
        coded_matmul_cuda(a, x, idx, w, 5)
    assert torch.equal(coded_matmul_cuda(a, x, idx, w, 8), torch.zeros((24, 4), device=card))
