"""Public attention op: device dispatch (port of
``repro.kernels.flash_attention.ops``).

A CUDA tensor goes to the kernel (``kernel.flash_attention_cuda``), a CPU
tensor to the plain version, with the reference's jnp dispatch:
``attention_ref`` up to ``CHUNKED_THRESHOLD`` keys, ``attention_chunked``
above.  The kernel masks ragged Tq/Tk itself and takes ``q_offset`` and
``tk_valid`` at run time, so unlike the reference's Pallas path nothing is
padded, and the KV-cache path (prefill and decode) runs on it too.

Where autograd records (grad mode on and q, k or v requiring grad), a CUDA
call goes through ``autograd.FlashAttentionFn``: K4's forward with its
log-sum-exp, and the backward kernel for the gradients.  The plain route is
differentiable as it stands.
"""

from __future__ import annotations

from typing import Optional

import torch

from .autograd import FlashAttentionFn
from .kernel import flash_attention_cuda
from .ref import attention_chunked, attention_ref

# Above this key length the plain route switches to the chunked online-softmax
# path (O(T*chunk) memory instead of O(T^2)).
CHUNKED_THRESHOLD = 2048

# Chunk length of the plain route's chunked path (the reference's scan
# ``unroll`` option has no counterpart in a Python loop).
CHUNK_OPTS = {"chunk": 1024}


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    tk_valid: Optional[int] = None,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Attention over (B, H, T, D) tensors; see ``ref.attention_ref`` for the
    semantics.  ``tk_valid`` (default Tk) is the valid key prefix, the
    reference's ``kv_len``.  ``use_kernel`` (the reference's ``use_pallas``)
    defaults to the device: the kernel for CUDA tensors, the plain version
    for CPU tensors.  Passing it asserts the route: ``True`` on CPU tensors
    or ``False`` on CUDA tensors raises."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel != q.is_cuda:
        raise ValueError(
            f"use_kernel={use_kernel} but q is on {q.device}: the kernel runs "
            "on CUDA tensors and the plain version on CPU tensors")
    if use_kernel:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, causal, window, softcap, q_offset, tk_valid)
        return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                    q_offset=q_offset, tk_valid=tk_valid)
    if k.shape[2] > CHUNKED_THRESHOLD:
        return attention_chunked(q, k, v, causal=causal, window=window, softcap=softcap,
                                 q_offset=q_offset, kv_len=tk_valid, **CHUNK_OPTS)
    return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                         q_offset=q_offset, kv_len=tk_valid)


def attention_flops(
    B: int, Hq: int, Tq: int, Tk: int, D: int,
    causal: bool, window: Optional[int],
) -> float:
    """Useful FLOPs of one attention call (both matmuls), accounting for the
    causal/window sparsity the kernel actually exploits (the reference's
    count, copied)."""
    if window is not None:
        pairs = sum(min(w + 1, q + 1 if causal else Tk)
                    for q, w in ((i, window - 1) for i in range(Tq)))
    elif causal:
        off = Tk - Tq
        pairs = sum(min(off + i + 1, Tk) for i in range(Tq))
    else:
        pairs = Tq * Tk
    return 2.0 * 2.0 * B * Hq * pairs * D
