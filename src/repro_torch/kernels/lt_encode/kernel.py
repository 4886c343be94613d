"""Wrapper of the standalone LT-encode CUDA kernel (K2).

The kernel is ``csrc/lt_encode.cu`` (see its header for the design and what
bounds it); it replaces the Pallas TPU kernel
``repro.kernels.lt_encode.kernel.lt_encode_pallas``.  This wrapper checks
what the kernel takes, allocates the output and the scratch of the
non-finite row marks, launches on PyTorch's current stream without
synchronising, and counts its launches in ``lt_encode_cuda.launches``.  It
takes CUDA tensors only; the plain version for the CPU is
``kernels.coded_matmul.ref.lt_encode_ref``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...utils import trace
from .. import _nvcc

SOURCE = "lt_encode.cu"


def lt_encode_costs(R: int, bm: int, cols: int, C: int, d_max: int, nnz: int,
                    elem: int) -> Tuple[float, int]:
    """(FLOPs, bytes) of one call, the counts of its bound: a multiply-add
    per element of each nonzero-weight neighbour block (2 nnz bm cols); A,
    idx and the weights read once, the coded blocks written once."""
    return 2.0 * nnz * bm * cols, (R * bm + C * bm) * cols * elem + 2 * 4 * C * d_max


def _lib():
    return _nvcc.bind(SOURCE, "lt_encode", 5, 6)


def lt_encode_cuda(
    a: torch.Tensor,        # (R * bm, cols) float32 or bfloat16
    idx: torch.Tensor,      # (C, d_max) int32
    weights: torch.Tensor,  # (C, d_max) float32: ±1 coefficients, 0 = padding
    bm: int,
) -> torch.Tensor:
    """``coded[b] = sum_j weights[b,j] * A[idx[b,j]]`` over bm-row blocks, as
    a (C * bm, cols) tensor of a's type, accumulated in float32.  Weights
    are float coefficients: a bool mask must be converted with ``.float()``
    (0/1), never the other way, which would drop the parity signs."""
    _nvcc.check_cuda("lt_encode_cuda", "lt_encode_ref", a.device, a=a, idx=idx,
                     weights=weights)
    if a.dtype not in _nvcc.DTYPE_CODE:
        raise ValueError(f"a must be one of {list(_nvcc.DTYPE_CODE)}; got {a.dtype}")
    if idx.dtype != torch.int32 or weights.dtype != torch.float32:
        raise ValueError(f"idx must be int32 and weights float32; got "
                         f"{idx.dtype} and {weights.dtype}")
    if a.dim() != 2 or idx.dim() != 2 or weights.shape != idx.shape:
        raise ValueError(f"need a (R*bm, cols) and idx, weights (C, d_max); got "
                         f"{tuple(a.shape)}, {tuple(idx.shape)}, {tuple(weights.shape)}")
    if bm <= 0 or a.shape[0] % bm:
        raise ValueError(f"a rows {a.shape[0]} not divisible by bm={bm}")
    (C, d_max), cols, R = idx.shape, a.shape[1], a.shape[0] // bm
    if max(C, R) > _nvcc.MAX_GRID_YZ or d_max > _nvcc.MAX_D:
        raise ValueError(f"C={C} coded blocks of d_max={d_max} neighbours over R={R} source "
                         f"blocks exceed the kernel's limits ({_nvcc.MAX_GRID_YZ}, {_nvcc.MAX_D})")
    out = torch.empty((C * bm, cols), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty((R + R * bm,), dtype=torch.uint8, device=a.device)  # row marks
    _nvcc.launch(_lib(), "lt_encode", a.device, a.data_ptr(), idx.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), R, bm, cols, C, d_max,
                 _nvcc.DTYPE_CODE[a.dtype])
    lt_encode_cuda.launches += 1
    if trace.counting():
        with trace.uncounted():
            nnz = int((weights != 0).sum())
        trace.count_kernel("lt_encode", *lt_encode_costs(R, bm, cols, C, d_max, nnz,
                                                          a.element_size()))
    return out


lt_encode_cuda.launches = 0
