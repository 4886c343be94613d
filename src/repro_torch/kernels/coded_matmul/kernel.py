"""Wrapper of the fused LT-encode + block-matmul CUDA kernel (K1).

The kernel is ``csrc/coded_matmul.cu`` (see its header for the design and
what bounds it); it replaces the Pallas TPU kernel
``repro.kernels.coded_matmul.kernel.coded_matmul_pallas``.  This wrapper
checks what the kernel takes, allocates the output, launches on PyTorch's
current stream without synchronising, and counts its launches in
``coded_matmul_cuda.launches``.  It takes CUDA tensors only; the plain
version for the CPU is ``ref.coded_matmul_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _nvcc

SOURCE = "coded_matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Z = 65535  # CUDA's limit on the grid's z extent (one per coded block)
_MAX_D = 2048  # neighbour slots per row: the compacted list lives in shared memory


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _nvcc.load(SOURCE)
    lib.coded_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.coded_matmul_launch.restype = ctypes.c_int
    lib.coded_matmul_error_string.argtypes = [ctypes.c_int]
    lib.coded_matmul_error_string.restype = ctypes.c_char_p
    return lib


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
    tensors = dict(a=a, x=x, idx=idx, weights=weights)
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"coded_matmul_cuda takes CUDA tensors; {name} is "
                             f"on {t.device} (use ref.coded_matmul_ref there)")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype not in _DTYPE_CODE or x.dtype != a.dtype:
        raise ValueError(f"a and x must share one type of {list(_DTYPE_CODE)}; "
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
    (C, d_max), (k, n) = idx.shape, x.shape
    if C > _MAX_GRID_Z or d_max > _MAX_D:
        raise ValueError(f"C={C} coded blocks of d_max={d_max} neighbours exceed "
                         f"the kernel's limits ({_MAX_GRID_Z}, {_MAX_D})")
    out = torch.empty((C * bm, n), dtype=x.dtype, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _lib()
        rc = lib.coded_matmul_launch(
            a.data_ptr(), x.data_ptr(), idx.data_ptr(), weights.data_ptr(),
            out.data_ptr(), a.shape[0] // bm, bm, k, n, C, d_max,
            _DTYPE_CODE[a.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"coded_matmul launch failed: CUDA error {rc} "
                           f"({lib.coded_matmul_error_string(rc).decode()})")
    coded_matmul_cuda.launches += 1
    return out


coded_matmul_cuda.launches = 0
