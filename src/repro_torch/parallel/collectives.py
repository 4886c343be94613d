"""Collective helpers over ``torch.distributed`` ranks: the coded weighted
sum and the vocab-sharded cross-entropy (port of
``repro.parallel.collectives``).

``coded_psum`` is the aggregation primitive of coded gradient aggregation:
each rank contributes ``weight * value`` and the sum over the group is the
R-of-(R+K) decode for the current survivor set; the weights are a tiny
input, so a new survivor set needs no new program.  Where the reference
calls ``psum`` inside ``shard_map``, these functions run in every rank of
``group`` (:func:`repro_torch.launch.mesh.init_ranks`) and reduce with
``all_reduce``.

A tree is reduced in few calls: its leaves are grouped by dtype and device
into buckets of up to ``BUCKET_BYTES``, each flattened into one buffer; a
leaf larger than a bucket is reduced in place in bucket-sized pieces.  Gloo
takes CUDA tensors (ranks that share a card: it stages them through host
memory itself), NCCL takes them across cards.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Union

import torch
import torch.distributed as dist

from ..models.common import tree_leaves, tree_map
from . import tensor

__all__ = ["all_reduce_tree", "coded_psum", "sharded_cross_entropy", "weighted_sum"]

PyTree = Any

BUCKET_BYTES = 256 << 20


def all_reduce_tree(tree: PyTree, group=None, kind: str = "all_reduce_tree") -> PyTree:
    """Sum every leaf of ``tree`` over ``group`` in place and return it,
    bucketed as the module says (counted under ``kind`` in
    ``parallel.tensor.COUNTS``)."""
    leaves = tree_leaves(tree)
    bucket: List[torch.Tensor] = []

    def flush():
        if len(bucket) == 1:
            tensor.all_reduce(bucket[0], group, kind=kind)
        elif bucket:
            flat = torch.cat([x.reshape(-1) for x in bucket])
            tensor.all_reduce(flat, group, kind=kind)
            for x, piece in zip(bucket, flat.split([x.numel() for x in bucket])):
                x.copy_(piece.view_as(x))
        bucket.clear()

    size = 0
    for x in leaves:
        if not x.is_contiguous():
            raise ValueError("all_reduce_tree reduces contiguous leaves in place")
        nbytes = x.numel() * x.element_size()
        if bucket and (x.dtype != bucket[0].dtype or x.device != bucket[0].device
                       or size + nbytes > BUCKET_BYTES):
            flush()
            size = 0
        if nbytes > BUCKET_BYTES:
            flat, piece = x.view(-1), BUCKET_BYTES // x.element_size()
            for i in range(0, flat.numel(), piece):
                tensor.all_reduce(flat[i:i + piece], group, kind=kind)
            continue
        bucket.append(x)
        size += nbytes
    flush()
    return tree


def weighted_sum(trees: Sequence[PyTree], weights: Sequence[float]) -> PyTree:
    """``sum_j weights[j] * trees[j]`` leaf by leaf in fp32, in order (the
    first term ``weights[0] * leaf``, then each next one's ``weight * leaf``
    added).  Computed in place: the trees' fp32 leaves are overwritten (the
    result is the first tree's), so a worker's gradients need no third
    copy."""
    def one(*leaves):
        acc = leaves[0].float().mul_(weights[0])
        for w, x in zip(weights[1:], leaves[1:]):
            acc.add_(x.float().mul_(w))
        return acc

    return tree_map(one, trees[0], *trees[1:])


def coded_psum(tree: Union[PyTree, Sequence[PyTree]], weight, group=None) -> PyTree:
    """The sum over ``group`` of ``weight * leaf`` in fp32: this rank's
    decode coefficient times its value, summed over the ranks.

    ``weight`` is a scalar (a float or a 0-d tensor), or a sequence of them
    with ``tree`` a sequence of as many trees: the rank then contributes
    ``sum_j weight[j] * tree[j]`` (a worker's own gradient and its parity
    gradient, each with its decode weight).  Returns fp32 tensors; fp32
    leaves of ``tree`` are reused for them (:func:`weighted_sum`)."""
    if isinstance(weight, (list, tuple)):
        local = weighted_sum(tree, [float(w) for w in weight])
    else:
        local = weighted_sum([tree], [float(weight)])
    return all_reduce_tree(local, group)


def sharded_cross_entropy(
    logits: torch.Tensor,       # (..., V_local): this rank's vocab shard
    labels: torch.Tensor,       # (...): global vocab ids
    vocab_start: int,           # first vocab id of this shard
    group=None,
) -> torch.Tensor:
    """Cross-entropy over a vocab-sharded logits tensor without gathering
    the full vocab: the max by an all-reduce MAX, the softmax's denominator
    and the gold logit by all-reduce SUMs over ``group``.  Every rank
    returns the same mean.  The all-reduces carry values, not gradients:
    this is the loss's forward value."""
    lmax = logits.amax(dim=-1)
    dist.all_reduce(lmax, op=dist.ReduceOp.MAX, group=group)
    denom = torch.exp(logits - lmax[..., None]).sum(dim=-1)
    dist.all_reduce(denom, op=dist.ReduceOp.SUM, group=group)
    local = labels.long() - int(vocab_start)
    v_local = logits.shape[-1]
    in_shard = (local >= 0) & (local < v_local)
    safe = local.clamp(0, v_local - 1)
    gold_local = torch.gather(logits, -1, safe[..., None])[..., 0]
    gold = torch.where(in_shard, gold_local - lmax, 0.0)
    dist.all_reduce(gold, op=dist.ReduceOp.SUM, group=group)
    return (torch.log(denom) - gold).mean()
