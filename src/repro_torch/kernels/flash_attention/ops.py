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

DTensor q, k and v (heads over a model axis, ``models.attention`` under
tensor parallelism) run on each rank's local heads: their local tensors
take the route above (K4 and its backward on the card, the plain version
on the CPU) and the output is a DTensor laid out as q.  Three layouts, by
the sharding rules: q and kv heads both split (each rank's q heads read
its own kv heads); q heads split with the kv heads whole (q head h reads
kv head h // (Hq / Hkv) of the whole model: each rank takes the kv heads
its q heads read); q heads whole (k and v are gathered whole first).
"""

from __future__ import annotations

from typing import Optional

import torch

from .autograd import FlashAttentionFn
from .kernel import flash_attention_cuda, shape_only
from .ref import attention_chunked, attention_ref

# Above this key length the plain route switches to the chunked online-softmax
# path (O(T*chunk) memory instead of O(T^2)).
CHUNKED_THRESHOLD = 2048

# Chunk length of the plain route's chunked path (the reference's scan
# ``unroll`` option has no counterpart in a Python loop).
CHUNK_OPTS = {"chunk": 1024}


def set_chunk_opts(chunk: int = 1024, unroll: bool = False) -> None:
    """The reference's knob of its chunked path: ``chunk`` keys a step of
    the plain route's online softmax.  ``unroll`` unrolls the reference's
    ``lax.scan`` over the chunks; the port's chunks are a Python loop,
    already unrolled, so it is accepted and changes nothing."""
    del unroll
    CHUNK_OPTS["chunk"] = int(chunk)


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
    or ``False`` on CUDA tensors raises.  A shape-only tensor (fake or
    ``meta``: the steps of ``launch/dryrun``) takes the route
    ``use_kernel`` names on any device: the kernel's route counts the call
    and launches nothing."""
    if _is_dtensor(q):
        return _sharded_heads(q, k, v, causal=causal, window=window, softcap=softcap,
                              q_offset=q_offset, tk_valid=tk_valid, use_kernel=use_kernel)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel != q.is_cuda and not shape_only(q):
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


def _is_dtensor(x) -> bool:
    from ...parallel.tensor import is_dtensor

    return is_dtensor(x)


def kv_heads_for(rank: int, hq_local: int, n_q: int, n_kv: int):
    """The kv heads that q heads ``[rank * hq_local, (rank + 1) * hq_local)``
    of ``n_q`` read (q head h reads kv head h // (n_q / n_kv)): ``(start,
    stop)``, a contiguous range, when they read it in equal runs (the
    local call is then GQA over it), else the kv head of each q head."""
    g = n_q // n_kv
    idx = [(rank * hq_local + j) // g for j in range(hq_local)]
    lo, hi = idx[0], idx[-1] + 1
    per = hq_local // (hi - lo)
    if per * (hi - lo) == hq_local and idx == [lo + j // per for j in range(hq_local)]:
        return (lo, hi)
    return idx


def _sharded_heads(q, k, v, **opts):
    """:func:`flash_attention` of DTensors over a 1-D model mesh (see the
    module's docstring)."""
    from torch.distributed.tensor import DTensor, Shard

    from ...parallel import tensor as tp

    def split_heads(t):
        return isinstance(t.placements[0], Shard) and t.placements[0].dim == 1

    mesh = q.device_mesh
    ql = q.to_local()
    if not split_heads(q):
        kl = tp.whole(k) if split_heads(k) else k.to_local()
        vl = tp.whole(v) if split_heads(v) else v.to_local()
    elif split_heads(k):
        kl, vl = k.to_local(), v.to_local()
    else:
        sel = kv_heads_for(mesh.get_local_rank(0), ql.shape[1], q.shape[1], k.shape[1])
        kl, vl = k.to_local(), v.to_local()
        if isinstance(sel, tuple):
            kl, vl = kl[:, sel[0]:sel[1]], vl[:, sel[0]:sel[1]]
        else:
            kl, vl = kl[:, sel], vl[:, sel]
    out = flash_attention(ql, kl.contiguous(), vl.contiguous(), **opts)
    return DTensor.from_local(out, mesh, q.placements, run_check=False, shape=q.shape,
                              stride=q.stride())


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
