"""Wrapper of the LT peeling-round CUDA kernel (K3).

The kernel is ``csrc/lt_decode.cu`` (see its header for the design and what
bounds it); it replaces the Pallas TPU kernel
``repro.kernels.lt_decode.kernel.lt_decode_round_pallas``.  One launch runs
one round of a peeling plan and writes the recovered blocks straight into
``src`` (in place).  This wrapper checks what the kernel takes, allocates the
scratch of the non-finite row marks, launches on PyTorch's current stream
without synchronising, and counts its launches in
``lt_decode_round_cuda.launches``.  It takes CUDA tensors only; the plain
version for the CPU is ``ref.peel_round_ref``.
"""

from __future__ import annotations

import torch

from .. import _nvcc

SOURCE = "lt_decode.cu"


def _lib():
    return _nvcc.bind(SOURCE, "lt_decode_round", 8, 7)


def lt_decode_round_cuda(
    coded: torch.Tensor,      # (n_rx * bm, cols) received coded blocks
    src: torch.Tensor,        # (R * bm, cols) sources, updated in place; coded's type
    cpos: torch.Tensor,       # (S,) int32 coded-block position of each entry
    dst: torch.Tensor,        # (S,) int32 source block each entry recovers
    idx: torch.Tensor,        # (S, d_max) int32 neighbour source blocks
    w: torch.Tensor,          # (S, d_max) float32 neighbour coefficients (0 = padding)
    inv_pivot: torch.Tensor,  # (S,) float32 1 / pivot
    bm: int,
) -> torch.Tensor:
    """One peel round: ``src[dst[s]] = (coded[cpos[s]] - sum_j w[s,j] *
    src[idx[s,j]]) * inv_pivot[s]`` for every entry s, in float32, written
    into ``src``, which is returned.  Every nonzero-weight neighbour must be
    recovered before the round and no ``dst`` may repeat, as in the rounds
    of :func:`repro_torch.core.fountain.plan_rounds`."""
    _nvcc.check_cuda("lt_decode_round_cuda", "ref.peel_round_ref", src.device, coded=coded,
                     src=src, cpos=cpos, dst=dst, idx=idx, w=w, inv_pivot=inv_pivot)
    if src.dtype not in _nvcc.DTYPE_CODE or coded.dtype != src.dtype:
        raise ValueError(f"coded and src must share one type of {list(_nvcc.DTYPE_CODE)}; "
                         f"got {coded.dtype} and {src.dtype}")
    if any(t.dtype != torch.int32 for t in (cpos, dst, idx)) or any(
            t.dtype != torch.float32 for t in (w, inv_pivot)):
        raise ValueError("cpos, dst and idx must be int32; w and inv_pivot float32")
    if (coded.dim() != 2 or src.dim() != 2 or coded.shape[1] != src.shape[1]
            or idx.dim() != 2 or w.shape != idx.shape
            or any(t.shape != (idx.shape[0],) for t in (cpos, dst, inv_pivot))):
        raise ValueError(f"need coded, src (rows, cols), idx and w (S, d_max) and "
                         f"cpos, dst, inv_pivot (S,); got {tuple(coded.shape)}, "
                         f"{tuple(src.shape)}, {tuple(idx.shape)}, {tuple(w.shape)}, "
                         f"{tuple(cpos.shape)}, {tuple(dst.shape)}, {tuple(inv_pivot.shape)}")
    if bm <= 0 or coded.shape[0] % bm or src.shape[0] % bm:
        raise ValueError(f"coded rows {coded.shape[0]} / src rows {src.shape[0]} "
                         f"not divisible by bm={bm}")
    (S, d_max), cols = idx.shape, src.shape[1]
    R, n_rx = src.shape[0] // bm, coded.shape[0] // bm
    if max(S, R) > _nvcc.MAX_GRID_YZ or d_max > _nvcc.MAX_D:
        raise ValueError(f"S={S} entries of d_max={d_max} neighbours over R={R} source blocks "
                         f"exceed the kernel's limits ({_nvcc.MAX_GRID_YZ}, {_nvcc.MAX_D})")
    if S == 0 or cols == 0:
        return src
    scratch = torch.empty((R + R * bm,), dtype=torch.uint8, device=src.device)  # row marks
    _nvcc.launch(_lib(), "lt_decode_round", src.device, coded.data_ptr(), src.data_ptr(),
                 cpos.data_ptr(), dst.data_ptr(), idx.data_ptr(), w.data_ptr(),
                 inv_pivot.data_ptr(), scratch.data_ptr(), R, n_rx, bm, cols, S, d_max,
                 _nvcc.DTYPE_CODE[src.dtype])
    lt_decode_round_cuda.launches += 1
    return src


lt_decode_round_cuda.launches = 0
