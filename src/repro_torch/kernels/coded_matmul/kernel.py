"""Wrapper of the fused LT-encode + block-matmul CUDA kernel (K1).

The kernel is ``csrc/coded_matmul.cu`` (see its header for the design and
what bounds it); it replaces the Pallas TPU kernel
``repro.kernels.coded_matmul.kernel.coded_matmul_pallas``.  This wrapper
checks what the kernel takes, allocates the output and the scratch,
launches on PyTorch's current stream without synchronising, and counts its
launches in ``coded_matmul_cuda.launches``.  One launch is the non-finite
row marks (``csrc/nonfinite_rows.cuh``), then for float32 the prologue
(every block that is not a plain copy of a source block encoded once into
a scratch buffer of C blocks, the row table the product reads, and the
TF32 split of X^T) and the 3xTF32 wgmma product; bfloat16 runs its
CUDA-core kernel after the marks.  It takes CUDA tensors only; the plain
version for the CPU is ``ref.coded_matmul_ref`` (``ref.coded_matmul_two_phase``
models the float32 design step by step).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...utils import trace
from .. import _nvcc

SOURCE = "coded_matmul.cu"


def coded_matmul_costs(R: int, bm: int, k: int, n: int, C: int, d_max: int,
                       elem: int) -> Tuple[float, int]:
    """(FLOPs, bytes) of one call, the counts of its bound: the C block
    products (2 C bm k n; the encode's FMAs run beside them on the CUDA
    cores); A, X, idx and the weights read once, the output written once."""
    nbytes = (R * bm * k + k * n + C * bm * n) * elem + 2 * 4 * C * d_max
    return 2.0 * C * bm * k * n, nbytes


def _lib():
    return _nvcc.bind(SOURCE, "coded_matmul", 9, 7)


def coded_matmul_cuda(
    a: torch.Tensor,        # (R * bm, k) float32 or bfloat16
    x: torch.Tensor,        # (k, n), a's type
    idx: torch.Tensor,      # (C, d_max) int32
    weights: torch.Tensor,  # (C, d_max) float32: ±1 coefficients, 0 = padding
    bm: int,
) -> torch.Tensor:
    """``V[b] = (sum_j weights[b,j] * A[idx[b,j]]) @ x`` for every coded block
    b, as a (C * bm, n) tensor of x's type.  Weights are float coefficients:
    a bool mask must be converted with ``.float()`` (0/1), never the other
    way, which would drop the parity signs."""
    _nvcc.check_cuda("coded_matmul_cuda", "ref.coded_matmul_ref", a.device,
                     a=a, x=x, idx=idx, weights=weights)
    if a.dtype not in _nvcc.DTYPE_CODE or x.dtype != a.dtype:
        raise ValueError(f"a and x must share one type of {list(_nvcc.DTYPE_CODE)}; "
                         f"got {a.dtype} and {x.dtype}")
    if idx.dtype != torch.int32 or weights.dtype != torch.float32:
        raise ValueError(f"idx must be int32 and weights float32; got "
                         f"{idx.dtype} and {weights.dtype}")
    if a.dim() != 2 or x.dim() != 2 or a.shape[1] != x.shape[0]:
        raise ValueError(f"need a (R*bm, k) and x (k, n); got {tuple(a.shape)} "
                         f"and {tuple(x.shape)}")
    if idx.dim() != 2 or weights.shape != idx.shape:
        raise ValueError(f"idx and weights must both be (C, d_max); got "
                         f"{tuple(idx.shape)} and {tuple(weights.shape)}")
    if bm <= 0 or a.shape[0] % bm:
        raise ValueError(f"a rows {a.shape[0]} not divisible by bm={bm}")
    (C, d_max), (k, n), R = idx.shape, x.shape, a.shape[0] // bm
    if max(C, R, -(-bm // 4)) > _nvcc.MAX_GRID_YZ or d_max > _nvcc.MAX_D:
        raise ValueError(f"C={C} coded blocks of d_max={d_max} neighbours over R={R} source "
                         f"blocks of bm={bm} rows exceed the kernel's limits ({_nvcc.MAX_GRID_YZ}, {_nvcc.MAX_D})")
    out = torch.empty((C * bm, n), dtype=x.dtype, device=a.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty((R + R * bm,), dtype=torch.uint8, device=a.device)  # row marks
    ptrs = [None, None, None]  # float32: the prologue's encoded blocks, row table, split X^T
    if a.dtype == torch.float32:
        kp = max(4, -(-k // 4) * 4)  # TMA rows: a multiple of 16 bytes
        ptrs = [torch.empty((C * bm, kp), dtype=torch.float32, device=a.device),
                torch.empty((C,), dtype=torch.int32, device=a.device),
                torch.empty((2, n, kp), dtype=torch.float32, device=a.device)]
    _nvcc.launch(_lib(), "coded_matmul", a.device, a.data_ptr(), x.data_ptr(), idx.data_ptr(),
                 weights.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 *(t.data_ptr() if t is not None else None for t in ptrs), R, bm, k, n, C,
                 d_max, _nvcc.DTYPE_CODE[a.dtype])
    coded_matmul_cuda.launches += 1
    if trace.counting():
        trace.count_kernel("coded_matmul", *coded_matmul_costs(R, bm, k, n, C, d_max,
                                                                a.element_size()))
    return out


coded_matmul_cuda.launches = 0
