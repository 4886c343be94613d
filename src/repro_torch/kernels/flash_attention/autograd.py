"""Attention as an autograd function: K4's forward and its backward kernel.

``FlashAttentionFn`` runs the forward with an ``lse`` buffer
(``kernel.flash_attention_cuda``), saves q, k, v, the output and the
log-sum-exp, and runs the backward kernel (``kernel.flash_attention_bwd_cuda``)
for the gradients: in training (float32, aligned rows, D <= 128) both on
the tensor cores in 3xTF32, the forward's prefill instance and the
backward's (``kernel.bwd_plan``).  ``ops.flash_attention`` sends CUDA tensors here when
autograd records (grad mode on and q, k or v requiring grad); without that
it calls the forward alone, as serving does.

The reference's Pallas kernel has no backward (no ``custom_vjp``): the
reference trains through its jnp oracle, and its gradient is ``jax.vjp`` of
``attention_ref``, which ``ref.attention_bwd_ref`` computes and the backward
kernel is held to.  The forward and the backward are arguments, so the tests
run this function with the plain versions (``ref.attention_fwd_ref``,
``ref.attention_bwd_ref``) in float64 under ``torch.autograd.gradcheck``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .kernel import flash_attention_bwd_cuda, flash_attention_cuda


def kernel_forward(q, k, v, *, causal, window, softcap, q_offset, kv_len):
    """K4's forward with its log-sum-exp: ``(out, lse)``."""
    B, Hq, Tq, _ = q.shape
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset, tk_valid=kv_len, lse=lse)
    return out, lse


def kernel_backward(q, k, v, o, do, lse, *, causal, window, softcap, q_offset, kv_len):
    """K4's backward kernel: ``(dq, dk, dv)``."""
    return flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset, tk_valid=kv_len)


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, causal, window, softcap, q_offset, kv_len, forward=None,
    backward=None)``: attention of (B, Hq, Tq, D) queries over (B, Hkv, Tk,
    D) keys and values with the options of ``ref.attention_ref``
    (``kv_len`` an int or None), differentiable in q, k and v.  ``forward``
    and ``backward`` default to the kernels (CUDA tensors); they take the
    signatures of ``ref.attention_fwd_ref`` and ``ref.attention_bwd_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], softcap: Optional[float],
                q_offset: int, kv_len: Optional[int], forward: Optional[Callable] = None,
                backward: Optional[Callable] = None):
        opts = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                    kv_len=kv_len)
        out, lse = (forward or kernel_forward)(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts, ctx.backward_fn = opts, backward or kernel_backward
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.backward_fn(q, k, v, out, do, lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None, None
