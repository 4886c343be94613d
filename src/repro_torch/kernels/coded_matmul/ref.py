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


# --- a plain model of the CUDA kernel's float32 design, step by step --------

def tf32_truncate(v: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits) by truncation, as the kernel
    splits: the 13 low mantissa bits cleared.  inf and NaN stay so."""
    return (v.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` as the kernel's tensor cores take it: each operand split
    into big = tf32(v) and small = tf32(v - big), both truncated, and
    small.big + big.small + big.big summed in float32 (the products of TF32
    values are exact in float32; the kernel adds each 32-deep k tile's sum
    to an fp32 total).  The small.small term is dropped."""
    a_big, x_big = tf32_truncate(a), tf32_truncate(x)
    a_small, x_small = tf32_truncate(a.float() - a_big), tf32_truncate(x.float() - x_big)
    return a_small @ x_big + a_big @ x_small + a_big @ x_big


def encode_table(idx: torch.Tensor, weights: torch.Tensor, r_blocks: int) -> torch.Tensor:
    """The prologue's row table: for each coded block, its source block when
    it has exactly one nonzero-weight neighbour in [0, R) and that weight is
    exactly 1 (the product reads it straight from A), else -1 (the block is
    encoded into its scratch slot)."""
    w = weights.float()
    real = (w != 0) & (idx >= 0) & (idx < r_blocks)
    one = real.sum(dim=1) == 1
    pos = real.int().argmax(dim=1, keepdim=True)
    direct = one & (w.gather(1, pos)[:, 0] == 1.0)
    return torch.where(direct, idx.gather(1, pos)[:, 0].int(), -1).to(torch.int32)


def coded_matmul_two_phase(
    a: torch.Tensor,        # (R * bm, k) float32
    x: torch.Tensor,        # (k, n) float32
    idx: torch.Tensor,      # (C, d_max)
    weights: torch.Tensor,  # (C, d_max) float coefficients, 0 = padding
    bm: int,
) -> torch.Tensor:
    """The float32 CUDA kernel's route in plain torch: the row table, the
    encode of the blocks it marks -1 (nonzero-weight neighbours in [0, R)
    only), the row gather, the 3xTF32 product, each non-finite output
    recomputed as a plain fp32 dot product, and NaN in the rows whose
    padding slots reach a non-finite source row.  Equal to
    :func:`coded_matmul_ref` within fp32 rounding, NaN for NaN."""
    r_blocks, k = a.shape[0] // bm, a.shape[1]
    blocks = a.float().reshape(r_blocks, bm, k)
    w = weights.float()
    inside = (idx >= 0) & (idx < r_blocks)
    table = encode_table(idx, w, r_blocks)
    safe = torch.where(inside, idx, 0).long()
    coef = torch.where(inside, w, 0.0)
    terms = torch.where((coef != 0)[:, :, None, None], blocks[safe] * coef[:, :, None, None], 0.0)
    encoded = torch.where((table >= 0)[:, None, None], blocks[table.clamp(min=0).long()],
                          terms.sum(dim=1))
    rows = encoded.reshape(-1, k)
    out = matmul_3xtf32(rows, x)
    bad = ~torch.isfinite(out)
    if bool(bad.any()):
        out = torch.where(bad, rows @ x.float(), out)
    pad = (w == 0) & inside                                          # (C, d_max)
    row_nonfinite = ~torch.isfinite(blocks).all(dim=2)               # (R, bm)
    nan_rows = (pad[:, :, None] & row_nonfinite[safe]).any(dim=1)    # (C, bm)
    out = torch.where(nan_rows.reshape(-1, 1), float("nan"), out)
    return out.to(x.dtype)
