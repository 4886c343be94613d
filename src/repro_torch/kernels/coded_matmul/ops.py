"""Public entry of the fused coded matmul: device dispatch and LTCode
plumbing.

A CUDA tensor goes to the kernel (``kernel.coded_matmul_cuda``), a CPU tensor
to the plain version (``ref.coded_matmul_ref``).  The kernel masks ragged
k/n edges itself, so unlike the reference's Pallas path nothing is padded.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.fountain import LTCode
from .kernel import coded_matmul_cuda
from .ref import coded_matmul_ref


def coded_matmul(
    a: torch.Tensor,
    x: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    *,
    bm: int,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """V[b*bm:(b+1)*bm] = (sum_j mask[b,j] A[idx[b,j]]) @ x for coded block b.

    a: (R*bm, k_dim); x: (k_dim, n_dim); idx/mask: (C, d_max), mask bool or
    float weights.  Returns (C*bm, n_dim) in x's type.

    ``use_kernel`` (the reference's ``use_pallas``) defaults to the device:
    the kernel for CUDA tensors, the plain version for CPU tensors.  Passing
    it asserts the route: ``True`` on CPU tensors or ``False`` on CUDA
    tensors raises, since a CUDA tensor never takes the plain version here.
    """
    if use_kernel is None:
        use_kernel = a.is_cuda
    if use_kernel != a.is_cuda:
        raise ValueError(
            f"use_kernel={use_kernel} but a is on {a.device}: the kernel runs "
            "on CUDA tensors and the plain version on CPU tensors")
    if not use_kernel:
        return coded_matmul_ref(a, x, idx, mask, bm)
    return coded_matmul_cuda(
        a.contiguous(), x.contiguous(), idx.to(torch.int32).contiguous(),
        mask.to(torch.float32).contiguous(), bm)


def coded_matmul_code(
    a: torch.Tensor,
    x: torch.Tensor,
    code: LTCode,
    *,
    bm: Optional[int] = None,
    **kw,
) -> torch.Tensor:
    """Convenience: drive the kernel from an LTCode. ``a`` rows must split
    into ``code.R`` equal blocks (bm inferred when not given)."""
    if bm is None:
        if a.shape[0] % code.R:
            raise ValueError(f"a rows {a.shape[0]} not divisible by R={code.R}")
        bm = a.shape[0] // code.R
    return coded_matmul(
        a, x, torch.as_tensor(code.idx, device=a.device),
        torch.as_tensor(code.weights, device=a.device), bm=bm, **kw)


def flops(R: int, K: int, bm: int, k_dim: int, n_dim: int, d_mean: float) -> dict:
    """Roofline terms for one fused coded matmul (copied from the reference).

    Returns flops of the matmul part, the encode adds, and the device-memory
    bytes moved with 2-byte (bf16) elements, fused and unfused.
    """
    C = R + K
    matmul = 2.0 * C * bm * k_dim * n_dim
    encode_adds = d_mean * C * bm * k_dim
    bytes_fused = 2.0 * (d_mean * C * bm * k_dim + k_dim * n_dim + C * bm * n_dim)
    bytes_unfused = bytes_fused + 2.0 * 2.0 * C * bm * k_dim  # write+read A_enc
    return dict(
        matmul_flops=matmul,
        encode_flops=encode_adds,
        hbm_bytes_fused=bytes_fused,
        hbm_bytes_unfused=bytes_unfused,
    )
