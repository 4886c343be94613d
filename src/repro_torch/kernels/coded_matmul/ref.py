"""Plain PyTorch version of the fused LT-encode + block-matmul kernel.

Semantics: the source matrix ``a`` is ``R`` row-blocks of ``bm`` rows.  For
each coded block ``b`` (of ``C = R + K`` total),

    A_enc[b] = sum_j mask[b, j] * A[idx[b, j]]          (LT encode)
    V[b]     = A_enc[b] @ x                             (block matmul)

Returns V as a ``(C * bm, n)`` matrix.  Mirrors
``repro.kernels.coded_matmul.ref``: the encode sum is taken in ``a.dtype``
(a bf16 encode rounds in bf16), the product in float32, and the result is
cast to ``x.dtype``.  The CUDA kernel (``kernel.py``) is held against it.
"""

from __future__ import annotations

import torch


def coded_matmul_ref(
    a: torch.Tensor,      # (R * bm, k_dim)
    x: torch.Tensor,      # (k_dim, n_dim)
    idx: torch.Tensor,    # (C, d_max) int — source-block neighbours
    mask: torch.Tensor,   # (C, d_max) bool/float — neighbour weights
    bm: int,
) -> torch.Tensor:
    if a.shape[0] % bm:
        raise ValueError(f"a rows {a.shape[0]} not divisible by bm={bm}")
    enc = lt_encode_ref(a, idx, mask, bm)               # (C * bm, k), a.dtype
    return (enc.float() @ x.float()).to(x.dtype)


def lt_encode_ref(
    a: torch.Tensor,      # (R * bm, n_cols)
    idx: torch.Tensor,    # (C, d_max)
    mask: torch.Tensor,   # (C, d_max)
    bm: int,
) -> torch.Tensor:
    """Encode-only oracle: returns (C * bm, n_cols)."""
    r_blocks = a.shape[0] // bm
    blocks = a.reshape(r_blocks, bm, a.shape[1])
    gathered = blocks[idx.long()]
    m = mask.to(a.dtype)[:, :, None, None]
    enc = (gathered * m).sum(dim=1)
    return enc.reshape(-1, a.shape[1])
