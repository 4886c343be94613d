"""Wrappers of the LT peeling-decode CUDA kernel (K3).

The kernel is ``csrc/lt_decode.cu`` (see its header for the design and what
bounds it); it replaces the Pallas TPU kernel
``repro.kernels.lt_decode.kernel.lt_decode_round_pallas``.  One launch walks
a whole peeling plan, given as the int32 program of ``schedule.py``, and
writes the recovered blocks straight into ``src`` (in place).
``lt_decode_plan_cuda`` checks what the kernel takes, launches on PyTorch's
current stream without synchronising, and counts its launches in
``lt_decode_plan_cuda.launches``; ``lt_decode_round_cuda`` is the one-round
call of the same kernel.  Both take CUDA tensors only; the plain versions
for the CPU are ``ref.lt_decode_program_ref`` and ``ref.peel_round_ref``.
"""

from __future__ import annotations

import torch

from ...utils import trace
from .. import _nvcc
from . import schedule

SOURCE = "lt_decode.cu"


def _lib():
    return _nvcc.bind(SOURCE, "lt_decode_plan", 3, 5)


def _check_blocks(wrapper: str, coded: torch.Tensor, src: torch.Tensor, bm: int) -> tuple:
    """(R, n_rx, L): the source and coded blocks of ``bm`` rows, L elements each."""
    if src.dtype not in _nvcc.DTYPE_CODE or coded.dtype != src.dtype:
        raise ValueError(f"{wrapper}: coded and src must share one type of "
                         f"{list(_nvcc.DTYPE_CODE)}; got {coded.dtype} and {src.dtype}")
    if coded.dim() != 2 or src.dim() != 2 or coded.shape[1] != src.shape[1]:
        raise ValueError(f"{wrapper}: need coded and src as (rows, cols); got "
                         f"{tuple(coded.shape)} and {tuple(src.shape)}")
    if bm <= 0 or coded.shape[0] % bm or src.shape[0] % bm:
        raise ValueError(f"coded rows {coded.shape[0]} / src rows {src.shape[0]} "
                         f"not divisible by bm={bm}")
    L = bm * src.shape[1]
    if L >= 2 ** 31:
        raise ValueError(f"a block of {L} elements exceeds the kernel's int32 block length")
    return src.shape[0] // bm, coded.shape[0] // bm, L


def lt_decode_plan_cuda(
    coded: torch.Tensor,    # (n_rx * bm, cols) received coded blocks
    src: torch.Tensor,      # (R * bm, cols) sources, updated in place; coded's type
    program: torch.Tensor,  # (n_words,) int32 schedule (schedule.plan_program)
    bm: int,
) -> torch.Tensor:
    """Run a peeling program in one launch: for each entry, in order,
    ``src[dst] = (coded[cpos] - sum_j w_j * src[idx_j]) * inv_pivot`` in
    float32, NaN where a padding block the entry names was non-finite at
    its round's start, written into ``src``, which is returned.  The blocks
    the program reads must hold their values (received or recovered earlier
    in it); the others may hold anything."""
    _nvcc.check_cuda("lt_decode_plan_cuda", "ref.lt_decode_program_ref", src.device,
                     coded=coded, src=src, program=program)
    R, n_rx, L = _check_blocks("lt_decode_plan_cuda", coded, src, bm)
    if program.dtype != torch.int32 or program.dim() != 1 or program.numel() % 4:
        raise ValueError(f"program must be 1-D int32 of a multiple of 4 words; got "
                         f"{program.dtype} {tuple(program.shape)}")
    if program.data_ptr() % 16:
        raise ValueError("program must start on a 16-byte boundary")
    if program.numel() == 0 or L == 0:
        return src
    _nvcc.launch(_lib(), "lt_decode_plan", src.device, coded.data_ptr(), src.data_ptr(),
                 program.data_ptr(), program.numel(), R, n_rx, L,
                 _nvcc.DTYPE_CODE[src.dtype])
    lt_decode_plan_cuda.launches += 1
    if trace.counting():
        with trace.uncounted():
            words = program.cpu().numpy()
        trace.count_kernel("lt_decode", *schedule.program_costs(words, L, src.element_size()))
    return src


lt_decode_plan_cuda.launches = 0


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
    of :func:`repro_torch.core.fountain.plan_rounds`; padding slots read
    ``src`` as it stands before the round.  The tables come to the host to
    build the round's program (one synchronisation), which one
    :func:`lt_decode_plan_cuda` launch runs."""
    _nvcc.check_cuda("lt_decode_round_cuda", "ref.peel_round_ref", src.device, coded=coded,
                     src=src, cpos=cpos, dst=dst, idx=idx, w=w, inv_pivot=inv_pivot)
    R, n_rx, _L = _check_blocks("lt_decode_round_cuda", coded, src, bm)
    if any(t.dtype != torch.int32 for t in (cpos, dst, idx)) or any(
            t.dtype != torch.float32 for t in (w, inv_pivot)):
        raise ValueError("cpos, dst and idx must be int32; w and inv_pivot float32")
    if (idx.dim() != 2 or w.shape != idx.shape
            or any(t.shape != (idx.shape[0],) for t in (cpos, dst, inv_pivot))):
        raise ValueError(f"need idx and w (S, d_max) and cpos, dst, inv_pivot (S,); got "
                         f"{tuple(idx.shape)}, {tuple(w.shape)}, {tuple(cpos.shape)}, "
                         f"{tuple(dst.shape)}, {tuple(inv_pivot.shape)}")
    if idx.shape[1] > _nvcc.MAX_D:
        raise ValueError(f"d_max={idx.shape[1]} exceeds the kernel's {_nvcc.MAX_D} slots")
    if idx.shape[0] == 0 or src.shape[1] == 0:
        return src
    words = schedule.round_program(*(t.cpu().numpy() for t in (cpos, dst, idx, w, inv_pivot)),
                                   R=R, n_rx=n_rx)
    if words.size:
        lt_decode_plan_cuda(coded, src, torch.as_tensor(words, device=src.device), bm)
        lt_decode_round_cuda.launches += 1
    return src


lt_decode_round_cuda.launches = 0
