"""Public entry of the standalone LT encode: device dispatch and LTCode
plumbing (port of ``repro.kernels.lt_encode.ops``).

A CUDA tensor goes to the kernel (``kernel.lt_encode_cuda``), a CPU tensor
to the plain version (``kernels.coded_matmul.ref.lt_encode_ref``).  The
kernel masks ragged columns itself, so unlike the reference's Pallas path
nothing is padded.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.fountain import LTCode
from ..coded_matmul.ref import lt_encode_ref
from .kernel import lt_encode_cuda


def lt_encode(
    a: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    *,
    bm: int,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """coded[b] = sum_j mask[b,j] * A[idx[b,j]] over bm-row blocks.

    a: (R*bm, n_cols) -> (C*bm, n_cols) in a's type; mask bool or float
    weights.  ``use_kernel`` (the reference's ``use_pallas``) defaults to
    the device: the kernel for CUDA tensors, the plain version for CPU
    tensors.  Passing it asserts the route: ``True`` on CPU tensors or
    ``False`` on CUDA tensors raises.
    """
    if use_kernel is None:
        use_kernel = a.is_cuda
    if use_kernel != a.is_cuda:
        raise ValueError(
            f"use_kernel={use_kernel} but a is on {a.device}: the kernel runs "
            "on CUDA tensors and the plain version on CPU tensors")
    if not use_kernel:
        if a.shape[0] % bm:
            raise ValueError(f"a rows {a.shape[0]} not divisible by bm={bm}")
        return lt_encode_ref(a, idx, mask, bm)
    return lt_encode_cuda(a.contiguous(), idx.to(torch.int32).contiguous(),
                          mask.to(torch.float32).contiguous(), bm)


def lt_encode_code(a: torch.Tensor, code: LTCode, *, bm: Optional[int] = None,
                   **kw) -> torch.Tensor:
    """Encode ``a`` with an LTCode's float weights (the ±1 coefficients).
    ``a`` rows must split into ``code.R`` equal blocks (bm inferred when not
    given)."""
    if bm is None:
        if a.shape[0] % code.R:
            raise ValueError(f"a rows {a.shape[0]} not divisible by R={code.R}")
        bm = a.shape[0] // code.R
    return lt_encode(a, torch.as_tensor(code.idx, device=a.device),
                     torch.as_tensor(code.weights, device=a.device), bm=bm, **kw)
