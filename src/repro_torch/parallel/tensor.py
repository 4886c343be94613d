"""Tensors laid out over a ``(data, model)`` ``DeviceMesh``: placing and
gathering parameter trees, the tensor-parallel operators of the model, and
the collectives' counts (the port of what GSPMD does for the reference's
sharded step).

A parameter is a ``DTensor`` whose placements come from
``parallel.sharding`` (``Shard(i)`` on the mesh dimension ``model`` where
its spec names ``model`` at dimension ``i``; ``Replicate()`` elsewhere).
The model computes on each rank's local shards, Megatron's way:

* :func:`copy_to` is the identity forward and sums the gradient over the
  model axis backward: the entry of a region where each rank holds a part
  of the heads, the ff columns or the vocabulary (and a replicated weight
  used inside one, as granite's single kv head);
* :func:`reduce_from` sums over the model axis forward and is the identity
  backward: the exit of a row-parallel product;
* :func:`whole` gathers a weight that the rules shard along a dimension the
  compute wants whole (the embed fallback, the experts of the dense MoE,
  the recurrent mixers), and takes this rank's chunk of the gradient
  backward: the ranks of the model axis compute the same values there.

A parameter sharded over ``data`` (the rules do that only for the experts'
ff of qwen3-235b at full width) is FSDP: :func:`whole` gathers it over the
data axis before use (again in remat's recompute, which reruns the
forward), and its gradient is summed over every data-parallel rank
(:func:`dp_group`: pod x data) and sliced back to this rank's shard in the
backward, so the step's own gradient all-reduce leaves it out
(:func:`data_shard_dim`).

Every collective here is gloo's or NCCL's ``all_reduce`` or ``all_gather``,
the two gloo takes for CUDA tensors of ranks that share a card, and is
counted by kind in :data:`COUNTS`: calls, bytes this rank sends, and wire
bytes by the reference's ring model (``utils.roofline.wire_bytes``): a
step that gathered the embedding table or the logits whole would show
there.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.common import tree_leaves, tree_map

PyTree = Any

# kind -> [calls, bytes, wire bytes] of the collectives run since the last
# reset_counts()
COUNTS: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0, 0.0])


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, Tuple[int, int]]:
    """kind -> (calls, bytes sent by this rank) since :func:`reset_counts`."""
    return {k: (v[0], v[1]) for k, v in sorted(COUNTS.items())}


def wire() -> Dict[str, float]:
    """kind -> wire bytes a rank since :func:`reset_counts`, by the ring
    model: an all-reduce of S bytes over P ranks 2 S (P-1)/P, an
    all-gather of a chunk of S bytes S (P-1)."""
    return {k: v[2] for k, v in sorted(COUNTS.items())}


def _count(kind: str, t: torch.Tensor, group, gather: bool = False) -> None:
    c = COUNTS[kind]
    nbytes = t.numel() * t.element_size()
    p = dist.get_world_size(group)
    c[0] += 1
    c[1] += nbytes
    c[2] += nbytes * (p - 1) if gather else 2.0 * nbytes * (p - 1) / p


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM, kind: str = "all_reduce"):
    """``dist.all_reduce`` in place, counted; returns ``t``."""
    _count(kind, t, group)
    dist.all_reduce(t, op=op, group=group)
    return t


def chunk_sizes(length: int, n: int) -> List[int]:
    """torch.chunk's split of ``length`` into ``n`` (DTensor's ``Shard``):
    ceil-sized chunks, the last shorter, any after it empty."""
    step = -(-length // n) if length else 0
    return [max(0, min(step, length - i * step)) for i in range(n)]


def all_gather(t: torch.Tensor, dim: int, group, full_len: Optional[int] = None,
               kind: str = "all_gather") -> torch.Tensor:
    """The chunks of ``group``'s ranks, in rank order, joined along ``dim``
    into ``full_len`` (default: the chunk's length times the group's size),
    a new tensor.  Chunks split as :func:`chunk_sizes` says travel padded
    to the longest."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    full_len = t.shape[dim] * n if full_len is None else int(full_len)
    sizes = chunk_sizes(full_len, n)
    t = t.contiguous()
    if t.shape[dim] < sizes[0]:
        pad = list(t.shape)
        pad[dim] = sizes[0] - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(t) for _ in range(n)]
    _count(kind, t, group, gather=True)
    dist.all_gather(parts, t, group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)


# ---------------------------------------------------------------- layouts


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def dense_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (no tensor made)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def local_shape(shape, mesh, placements: Sequence) -> Tuple[int, ...]:
    """The shape of this rank's chunk of a tensor of ``shape`` under
    ``placements`` (:func:`local_chunk`'s, no tensor made)."""
    from torch.distributed.tensor import Shard

    out, coord = list(shape), mesh.get_coordinate()
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out[pl.dim] = chunk_sizes(out[pl.dim], mesh.size(m))[coord[m]]
    return tuple(out)


def _chunk_of(full: torch.Tensor, mesh, placements: Sequence,
              coord: Sequence[int]) -> torch.Tensor:
    from torch.distributed.tensor import Shard

    out = full
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            sizes = chunk_sizes(full.shape[pl.dim], mesh.size(m))
            out = out.narrow(pl.dim, sum(sizes[:coord[m]]), sizes[coord[m]])
    return out


def local_chunk(full: torch.Tensor, mesh, placements: Sequence) -> torch.Tensor:
    """This rank's chunk of ``full`` under ``placements`` on ``mesh``
    (``torch.chunk`` along each sharded dimension by the rank's coordinate
    on that mesh dimension, as DTensor's ``Shard``): a new tensor."""
    return _chunk_of(full, mesh, placements, mesh.get_coordinate()).clone(
        memory_format=torch.contiguous_format)


def distribute(full: torch.Tensor, mesh, placements: Sequence):
    """A DTensor of ``full``'s values laid out by ``placements``; each rank
    keeps its chunk (no collective: every rank holds ``full``)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_chunk(full.detach(), mesh, placements), mesh,
                              list(placements), run_check=False, shape=full.shape,
                              stride=dense_strides(full.shape))


def like(value: torch.Tensor, ref):
    """``value`` (a local tensor of ``ref``'s local shape) as a DTensor laid
    out as ``ref`` is; ``value`` itself when ``ref`` is no DTensor."""
    if not is_dtensor(ref):
        return value
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(value, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def local(x) -> torch.Tensor:
    """A DTensor's local tensor (shares its storage); other tensors as they
    are."""
    return x.to_local() if is_dtensor(x) else x


def shardings_like(shardings: PyTree, like_tree: PyTree) -> PyTree:
    """``shardings`` (a ``(mesh, placements)`` a leaf) walked as
    ``like_tree``, by dict key: a tree ``tree_map`` can zip with
    ``like_tree`` (whose dicts may list their keys in another order)."""
    if isinstance(like_tree, dict):
        return {k: shardings_like(shardings[k], v) for k, v in like_tree.items()}
    if isinstance(like_tree, (list, tuple)):
        return type(like_tree)(shardings_like(shardings[i], v)
                               for i, v in enumerate(like_tree))
    return shardings


def place_tree(tree: PyTree, shardings: PyTree) -> PyTree:
    """``tree``'s tensors as DTensors by ``shardings`` (a ``(mesh,
    placements)`` a leaf, as ``sharding.param_shardings`` gives on a
    ``DeviceMesh``)."""
    return tree_map(lambda x, s: distribute(x, *s), tree, shardings_like(shardings, tree))


def full_tensor(x) -> torch.Tensor:
    """The whole value of a DTensor, a new tensor gathered over each mesh
    dimension it is sharded on (every rank of the mesh must call);
    anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    out = x.to_local().detach()
    if not any(isinstance(pl, Shard) for pl in x.placements):
        return out.clone()
    mesh = x.device_mesh
    for m in reversed(range(mesh.ndim)):
        pl = x.placements[m]
        if isinstance(pl, Shard):
            out = all_gather(out, pl.dim, mesh.get_group(m), full_len=x.shape[pl.dim],
                             kind="gather_full")
    return out


def gather_tree(tree: PyTree) -> PyTree:
    """:func:`full_tensor` of every leaf."""
    return tree_map(full_tensor, tree)


def writer_rank(tree: PyTree) -> Optional[int]:
    """The global rank that writes a tree holding DTensors (its mesh's
    first), or None when it holds none."""
    for x in tree_leaves(tree):
        if is_dtensor(x):
            return int(x.device_mesh.mesh.flatten()[0])
    return None


# ------------------------------------------------------ model-axis queries


def _model_dim(w) -> Optional[int]:
    names = w.device_mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def model_group(w):
    """The process group of ``w``'s model axis (None: not a DTensor, or a
    mesh without one)."""
    if not is_dtensor(w) or _model_dim(w) is None:
        return None
    return w.device_mesh.get_group("model")


def model_mesh(w):
    """The 1-D mesh of ``w``'s model axis: this data rank's model group."""
    return w.device_mesh["model"]


def model_shard_dim(w) -> Optional[int]:
    """The dimension ``w`` is split along over the model axis, or None."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(w) or _model_dim(w) is None:
        return None
    pl = w.placements[_model_dim(w)]
    return pl.dim if isinstance(pl, Shard) else None


def model_coord(w) -> int:
    """This rank's coordinate on ``w``'s model axis."""
    return w.device_mesh.get_coordinate()[_model_dim(w)]


def dp_group(mesh):
    """The group of the ranks that split the batch on ``mesh``: pod x data
    (one flattened group, :func:`launch.mesh.make_device_mesh` creates it
    with the mesh), 'data' on a mesh without 'pod'; None when that is one
    rank."""
    names = mesh.mesh_dim_names or ()
    if "pod" in names:
        return mesh["pod", "data"]._flatten("dp").get_group()
    if "data" in names and mesh.size(names.index("data")) > 1:
        return mesh.get_group("data")
    return None


def data_shard_dim(w) -> Optional[int]:
    """The dimension a DTensor is split along over 'data' (FSDP), or None."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(w):
        return None
    names = list(w.device_mesh.mesh_dim_names or ())
    pl = w.placements[names.index("data")] if "data" in names else None
    return pl.dim if isinstance(pl, Shard) else None


# ------------------------------------------------- differentiable operators


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group, kind="tp_grad_all_reduce"), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group, kind="tp_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(_ReduceFrom):
    @staticmethod
    def backward(ctx, g):
        return _CopyTo.backward(ctx, g)


def _own(chunk: torch.Tensor) -> torch.Tensor:
    """A chunk of a whole gradient in storage of its own: a view would keep
    the whole (a gathered weight's full size) alive as long as the chunk,
    to the end of the backward."""
    return chunk.clone(memory_format=torch.contiguous_format)


class _DataGather(torch.autograd.Function):
    """FSDP's gather over 'data': the gradient of the whole is summed over
    the data-parallel ranks and this rank's slice kept."""

    @staticmethod
    def forward(ctx, x, dim, group, sum_group, full_len):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        sizes = chunk_sizes(full_len, n)
        ctx.dim, ctx.start, ctx.size, ctx.sum_group = dim, sum(sizes[:r]), sizes[r], sum_group
        return all_gather(x, dim, group, full_len=full_len, kind="fsdp_gather")

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.sum_group, kind="fsdp_grad_all_reduce")
        return _own(g.narrow(ctx.dim, ctx.start, ctx.size)), None, None, None, None


def gather_data(x: torch.Tensor, w) -> torch.Tensor:
    """``x`` (a local tensor laid out as the DTensor ``w``) gathered whole
    along ``w``'s 'data' dimension, differentiably (:class:`_DataGather`);
    ``x`` itself when ``w`` is not split over 'data'."""
    dim = data_shard_dim(w)
    if dim is None:
        return x
    mesh = w.device_mesh
    return _DataGather.apply(x, dim, mesh.get_group("data"), dp_group(mesh), w.shape[dim])


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, full_len):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        sizes = chunk_sizes(full_len, n)
        ctx.dim, ctx.start, ctx.size = dim, sum(sizes[:r]), sizes[r]
        return all_gather(x, dim, group, full_len=full_len, kind="tp_gather")

    @staticmethod
    def backward(ctx, g):
        return _own(g.narrow(ctx.dim, ctx.start, ctx.size)), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward; the identity backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def sum_both(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward and of the gradients backward: a
    statistic every rank of ``group`` computes from all ranks' parts and
    each adds to its own loss (the MoE's load balance over 'data', whose
    ranks' gradients the step then averages)."""
    return x if group is None else _SumBoth.apply(x, group)


def whole(w) -> torch.Tensor:
    """A parameter's whole value as a local tensor, differentiably: a
    DTensor sharded over 'data' (FSDP) is gathered there first
    (:func:`gather_data`), one sharded over the model axis then gathered
    there (its gradient is this rank's chunk of the whole one, which the
    model axis's ranks compute alike); a plain tensor is itself."""
    if not is_dtensor(w):
        return w
    x = gather_data(w.to_local(), w)
    dim = model_shard_dim(w)
    if dim is None:
        return x
    return _Gather.apply(x, dim, model_group(w), w.shape[dim])


def whole_tree(tree: PyTree) -> PyTree:
    return tree_map(whole, tree)


def split(*pairs) -> Tuple[List[torch.Tensor], Optional[Any]]:
    """Local operands for a region split over the model axis: ``pairs`` are
    ``(w, dim)``, the dimension along which the region wants each weight
    split.  When every ``w`` is a DTensor split along its ``dim`` over the
    model axis, returns the local shards and the model group; otherwise
    each weight :func:`whole` and None (the ranks compute the region alike)."""
    ws = [w for w, _ in pairs]
    if all(is_dtensor(w) and model_shard_dim(w) == d for w, d in pairs):
        return [gather_data(w.to_local(), w) for w in ws], model_group(ws[0])
    return [whole(w) for w in ws], None


def any_dtensor(tree: PyTree) -> bool:
    return any(is_dtensor(x) for x in tree_leaves(tree))


# --------------------------------------------------- vocabulary over model


def embedding(table, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for a (vocab, d) table: split over the vocabulary
    on the model axis, each rank looks up the ids in its range (zeros
    elsewhere) and the rows are summed over the axis; else the whole
    table's rows."""
    (t,), group = split((table, 0))
    if group is None:
        return t[tokens.long()]
    v_loc = t.shape[0]
    lo = model_coord(table) * chunk_sizes(table.shape[0], dist.get_world_size(group))[0]
    ids = tokens.long() - lo
    inside = (ids >= 0) & (ids < v_loc)
    rows = torch.nn.functional.embedding(ids.clamp(0, v_loc - 1), t)
    return reduce_from(rows * inside[..., None].to(rows.dtype), group)


def vocab_logits(x: torch.Tensor, head, tied: bool):
    """Logits of x (B, T, d) over the vocabulary: ``x @ head.t()`` for a
    tied (vocab, d) table, ``x @ head`` for a (d, vocab) head.  Where the
    vocabulary is split over the model axis, each rank's logits are its
    range: returned as a DTensor sharded along the last dimension on the
    model axis's mesh (:func:`cross_entropy` reads it); else a tensor."""
    (w,), group = split((head, 0 if tied else 1))
    w = w.to(x.dtype)
    if group is None:
        return x @ (w.t() if tied else w)
    from torch.distributed.tensor import DTensor, Shard

    out = copy_to(x, group) @ (w.t() if tied else w)
    mesh = model_mesh(head)
    shape = (*out.shape[:-1], head.shape[0 if tied else 1])
    return DTensor.from_local(out, mesh, [Shard(out.dim() - 1)], run_check=False,
                              shape=torch.Size(shape),
                              stride=dense_strides(shape))


class _VocabParallelCE(torch.autograd.Function):
    """Mean token cross-entropy of logits split over the vocabulary: the max
    by an all-reduce MAX, the softmax's denominator and the gold logit by
    all-reduce SUMs; the gradient is each rank's (softmax - one-hot)
    columns, no collective."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        lmax = logits.amax(dim=-1)
        all_reduce(lmax, group, op=dist.ReduceOp.MAX, kind="ce_all_reduce")
        z = logits - lmax[..., None]
        e = torch.exp(z)
        denom = e.sum(dim=-1)
        all_reduce(denom, group, kind="ce_all_reduce")
        ids = labels.long() - lo
        inside = (ids >= 0) & (ids < logits.shape[-1])
        safe = ids.clamp(0, logits.shape[-1] - 1)
        gold = torch.where(inside, torch.gather(z, -1, safe[..., None])[..., 0], 0.0)
        all_reduce(gold, group, kind="ce_all_reduce")
        ctx.save_for_backward(e, denom, safe, inside)
        return (torch.log(denom) - gold).mean()

    @staticmethod
    def backward(ctx, g):
        e, denom, safe, inside = ctx.saved_tensors
        p = e / denom[..., None]
        p.scatter_add_(-1, safe[..., None], -inside[..., None].to(p.dtype))
        return p * (g / denom.numel()), None, None, None


def cross_entropy(logits, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in fp32 of logits (B, T, V): a DTensor split over the
    vocabulary (:func:`vocab_logits`) takes the vocab-parallel loss, which
    every rank of the model axis returns alike."""
    if not is_dtensor(logits):
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return (lse - gold).mean()
    group = logits.device_mesh.get_group(0)
    lo = logits.device_mesh.get_local_rank(0) * chunk_sizes(
        logits.shape[-1], dist.get_world_size(group))[0]
    return _VocabParallelCE.apply(logits.to_local(), labels, lo, group)


# -------------------------------------------------------------- grad norms


def owned(x) -> bool:
    """Whether this rank's local values of ``x`` count in a sum over the
    mesh: on every mesh dimension ``x`` is not split along, only the rank
    at coordinate 0 counts (the others hold copies)."""
    from torch.distributed.tensor import Shard

    coord = x.device_mesh.get_coordinate()
    return all(isinstance(pl, Shard) or c == 0 for pl, c in zip(x.placements, coord))


def sum_over_mesh(values: torch.Tensor, mesh) -> torch.Tensor:
    """``values`` summed over every rank of ``mesh``, in place (one
    all-reduce a mesh dimension)."""
    for m in range(mesh.ndim):
        all_reduce(values, mesh.get_group(m), kind="norm_all_reduce")
    return values


def leaf_sq_norms(tree: PyTree, like_tree: PyTree = None) -> List[torch.Tensor]:
    """Each leaf's sum of squares in fp32 over its whole value: a DTensor's
    (or, with ``like_tree``, a local tensor laid out as that tree's
    DTensor) summed over the mesh, every distinct element once."""
    leaves = tree_leaves(tree)
    refs = leaves if like_tree is None else tree_leaves(like_tree)
    mesh = next((r.device_mesh for r in refs if is_dtensor(r)), None)
    sq = [torch.sum(torch.square(local(x).float())) for x in leaves]
    if mesh is None:
        return sq
    stacked = torch.stack([s if (not is_dtensor(r) or owned(r)) else torch.zeros_like(s)
                           for s, r in zip(sq, refs)])
    return list(sum_over_mesh(stacked, mesh).unbind(0))
