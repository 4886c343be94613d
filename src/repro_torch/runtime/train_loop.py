"""Training step factories: the microbatched step and the coded-DP step
(port of ``repro.runtime.train_loop``).

``make_train_step`` builds the production step: gradient accumulation over
microbatches (an fp32 accumulator), remat per layer when the model was
built with it, AdamW update.  Given a data group of ``torch.distributed``
ranks (:func:`repro_torch.launch.mesh.init_ranks`), each rank runs its
shard of the global batch and the gradients are averaged over the group,
as the reference's GSPMD step over a 'data' mesh axis.

``make_coded_train_step`` is the paper's contribution wired into DP: every
worker computes its own microbatch gradient plus (round-robin) one parity
gradient — the gradient of a sparse sum of neighbour microbatches — and
aggregation is a *weighted* sum whose weights (a tiny input) realize the
R-of-(R+K) decode for the current survivor set.  Given a data group of R
ranks, rank w is worker w and the sum is ``parallel.collectives.coded_psum``
over the group (the reference's weighted ``psum`` over the data axis);
without one the R workers run in turn and the sum is taken in worker
order.

Given a ``(data, model)`` or ``(pod, data, model)`` ``DeviceMesh`` of
ranks instead (:func:`repro_torch.launch.mesh.make_device_mesh`),
``make_train_step`` trains tensor parallel: the parameters are DTensors
laid out by the reference's rules (``parallel.sharding``,
``parallel.tensor.place_tree``), each rank takes its rows of the batch
where ``batch_spec`` splits it over pod x data or data (the whole batch
where it does not divide), the model axis's ranks compute their heads, ff
columns and vocabulary range, the gradients (DTensors laid out as the
parameters) are averaged over pod x data, and AdamW updates
ZeRO-1-sharded moments.  A weight the rules split over 'data' (FSDP) is
gathered before use and its gradient summed in the backward.  ``make_coded_train_step`` takes such a mesh too:
as in the reference's coded step the parameters are whole on every rank,
data rank w is worker w and the weighted sum runs over 'data' only (the
model axis's ranks compute their worker alike).

Gradients come from ``torch.autograd.grad`` on detached aliases of the
parameter leaves, so the caller's tensors need not require grad and carry
no ``.grad``.  The optimizer updates in place (``optim.adamw.apply``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _device
from ..core import gradient_coding
from ..models.common import tree_leaves, tree_map
from ..models.model import Model
from ..optim import adamw
from ..parallel import collectives
from ..parallel import tensor as tp
from ..parallel.sharding import batch_spec, mesh_shape

PyTree = Any


def _as_tensors(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items() if v is not None}


def _reshape_micro(batch: Dict[str, torch.Tensor], n_micro: int):
    def r(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} is not a multiple of n_micro {n_micro}")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])

    return {k: r(v) for k, v in batch.items()}


def _rank_slice(micro: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """This rank's shard of every microbatch of a (n_micro, mb, ...) batch:
    rows [r * mb / D, (r + 1) * mb / D) of each, for rank r of D."""
    r, D = dist.get_rank(group), dist.get_world_size(group)

    def one(x):
        mb = x.shape[1]
        if mb % D:
            raise ValueError(f"a microbatch of {mb} does not split over {D} ranks")
        return x[:, r * (mb // D):(r + 1) * (mb // D)]

    return {k: one(v) for k, v in micro.items()}


def _data_rows(micro: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of every microbatch of a (n_micro, mb, ...) batch
    as ``batch_spec`` splits mb: over ('pod', 'data') (pod-major) or
    'data' alone; the whole microbatch where it does not divide (as the
    reference's spec leaves it)."""
    names, coord, sizes = list(mesh.mesh_dim_names), mesh.get_coordinate(), mesh_shape(mesh)

    def one(x):
        mb = x.shape[1]
        axes = batch_spec(mesh, mb)[0]
        if axes is None:
            return x
        i, n = 0, 1
        for a in (axes,) if isinstance(axes, str) else axes:
            i, n = i * sizes[a] + coord[names.index(a)], n * sizes[a]
        return x[:, i * (mb // n):(i + 1) * (mb // n)]

    return {k: one(v) for k, v in micro.items()}


def _device_of(params: PyTree) -> torch.device:
    return tree_leaves(params)[0].device


def _on(params: PyTree, dev: torch.device) -> torch.device:
    """The step's device, which the parameters must be on."""
    have = _device_of(params)
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"the parameters are on {have}, the step runs on {dev}")
    return have


def value_and_grad(loss_fn: Callable, params: PyTree, batch) -> Tuple[torch.Tensor, PyTree]:
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the loss detached,
    the gradients a tree like ``params`` (a DTensor's as its local
    tensor)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    it = iter(tp.local(g) for g in grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def accumulate_grads(model: Model, params: PyTree,
                     micro: Dict[str, torch.Tensor]) -> Tuple[PyTree, torch.Tensor]:
    """The mean gradient and loss over the leading microbatch axis of
    ``micro`` (n_micro, mb, ...): each microbatch's gradient summed in fp32
    (in order, from zero), then divided, as the reference's scan does.  The
    sums are contiguous (a bf16 leaf's gradient may come strided; the
    step's all-reduce works in place)."""
    n = next(iter(micro.values())).shape[0]
    gsum, lsum = None, torch.zeros((), dtype=torch.float32, device=_device_of(params))
    for i in range(n):
        loss, grads = value_and_grad(model.loss_fn, params, {k: v[i] for k, v in micro.items()})
        if gsum is None:
            gsum = tree_map(lambda g: g.float().contiguous(), grads)
        else:
            tree_map(lambda a, g: a.add_(g.float()), gsum, grads)
        lsum = lsum + loss
        del grads
    return tree_map(lambda g: g.div_(n), gsum), lsum / n


def make_train_step(
    model: Model,
    opt_cfg: adamw.AdamWConfig,
    n_microbatches: int = 1,
    pre_shaped: bool = False,
    device=None,
    group=None,
    mesh=None,
) -> Callable:
    """(params, opt_state, batch) -> (params', opt_state', metrics), the
    parameters and moments updated in place.

    ``pre_shaped``: batch arrays already carry the leading (n_micro, mb, ...)
    layout (the data pipeline produces this).  ``device`` (default ``cuda``;
    raises without a card unless ``"cpu"``) is where the step runs: the
    parameters must be there, and the batch arrays (numpy or tensors) go
    there.  ``metrics``: ``loss`` (a scalar tensor on that device) and those
    of ``adamw.apply``.

    ``group``: a data group of D ranks.  Every rank is given the same global
    batch and takes its shard of each microbatch (``mb / D`` rows); the
    ranks' mean gradients and losses are summed over the group in one
    bucketed all-reduce and divided by D, so every rank applies the same
    update, the one-process step's on the whole batch.
    ``train_step.grads(params, batch)`` returns that gradient and loss
    without a step.

    ``mesh``: a ``(data, model)`` or ``(pod, data, model)`` ``DeviceMesh``
    (the module's docstring); ``params`` DTensors on it, the optimizer
    state from ``adamw.init(params, opt_state_shardings)``.  Every rank is
    given the same global batch; the gradients returned are DTensors laid
    out as the parameters, whole over 'data' but where a parameter is
    split there (FSDP).  The mean runs over pod x data, one flattened
    group (``parallel.tensor.dp_group``); an FSDP parameter's gradient is
    summed over it in the backward (``parallel.tensor.whole``) and only
    divided here.
    """
    dev = _device.resolve(device)
    if group is not None and mesh is not None:
        raise ValueError("give a data group or a mesh, not both")
    data_group = group if mesh is None else tp.dp_group(mesh)

    def step_grads(params, batch):
        b = _as_tensors(batch, _on(params, dev))
        mb = b if pre_shaped else _reshape_micro(b, n_microbatches)
        if group is not None:
            mb = _rank_slice(mb, group)
        elif mesh is not None:
            mb = _data_rows(mb, mesh)
        grads, loss = accumulate_grads(model, params, mb)
        if data_group is not None:
            D = dist.get_world_size(data_group)
            summed = [g for g, p in zip(tree_leaves(grads), tree_leaves(params))
                      if tp.data_shard_dim(p) is None]
            collectives.all_reduce_tree((summed, loss), data_group, kind="data_all_reduce")
            grads, loss = tree_map(lambda g: g.div_(D), grads), loss / D
        return tree_map(tp.like, grads, params), loss

    def train_step(params, opt_state, batch):
        grads, loss = step_grads(params, batch)
        params, opt_state, metrics = adamw.apply(opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    train_step.grads = step_grads
    return train_step


def make_eval_step(model: Model, device=None) -> Callable:
    dev = _device.resolve(device)

    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss_fn(params, _as_tensors(batch, _on(params, dev)))

    return eval_step


# ---------------------------------------------------------------------------
# Coded data parallelism (the paper's technique in the training loop)
# ---------------------------------------------------------------------------

def make_coded_train_step(
    model: Model,
    opt_cfg: adamw.AdamWConfig,
    n_workers: int,
    n_parity: Optional[int] = None,
    seed: int = 0,
    device=None,
    group=None,
    mesh=None,
):
    """Coded-DP training step over ``n_workers`` (R) workers, run in turn
    on ``device`` (as in :func:`make_train_step`), or with ``group`` (a
    data group of R ranks) rank w as worker w, or over a ``(data, model)``
    ``DeviceMesh`` with R data ranks: data rank w is worker w, its model
    group's ranks compute it alike (whole parameters on every rank), and
    the sum runs over 'data'.

    Returns (train_step, code, weight_table) where
      train_step(params, opt_state, batch, weights) and
      batch["tokens"]: (R, mb, T), worker w's microbatch at [w],
      weights: (R+K,) decode weights (``weight_table``'s rows; pattern 0 is
      no straggler).  Worker w computes its own gradient and, if it holds
      one, parity k's (k % R == w): the gradient of sum_j c_j loss(mb_j)
      over the parity's neighbours; the update uses
      sum_w (weights[w] g_w + weights[R + k_w] g_parity_w) / R.
    ``train_step.grads(params, batch, weights)`` returns that gradient
    (before the division by R) and the weighted loss sum, without a step.
    With a group every rank gets the whole batch and the weights, computes
    worker w's two terms and ``coded_psum`` sums them over the group; every
    rank then applies the same update.
    """
    dev = _device.resolve(device)
    R = int(n_workers)
    if mesh is not None:
        if group is not None:
            raise ValueError("give a data group or a mesh, not both")
        group = mesh.get_group("data")
    if group is not None:
        if dist.get_world_size(group) != R:
            raise ValueError(f"{R} workers need a group of {R} ranks, got "
                             f"{dist.get_world_size(group)}")
    K = n_parity if n_parity is not None else max(1, R // 4)
    code = gradient_coding.make_gradient_code(R, K, seed=seed)
    # worker w's parity: the first k with k % R == w, its coded row and the
    # coefficient of each neighbour microbatch
    parity = [None] * R
    for k, nbrs in enumerate(gradient_coding.parity_assignments(code)):
        w = k % R
        if parity[w] is None:
            row = code.R + k
            cmap = {int(s): float(c) for s, c in
                    zip(code.idx[row][code.mask[row]], code.coef[row][code.mask[row]])}
            parity[w] = (row, [(int(s), cmap[int(s)]) for s in nbrs])

    def worker_terms(params, b, wts, w):
        """Worker w's terms and their decode weights: its own (gradient,
        loss), then, if it holds one, its parity's (gradient, 0)."""
        l_own, g_own = value_and_grad(model.loss_fn, params, {k: v[w] for k, v in b.items()})
        terms, weights = [(g_own, l_own)], [float(wts[w])]
        if parity[w] is not None:
            row, nbrs = parity[w]

            def parity_loss(p, _):
                return sum(c * model.loss_fn(p, {k: v[s] for k, v in b.items()})
                           for s, c in nbrs)

            _, g_par = value_and_grad(parity_loss, params, None)
            terms.append((g_par, torch.zeros_like(l_own)))
            weights.append(float(wts[row]))
        return terms, weights

    def coded_grads(params, batch_all, weights):
        b = _as_tensors(batch_all, _on(params, dev))
        wts = np.asarray(torch.as_tensor(weights).cpu(), dtype=np.float32)
        if group is not None:
            terms, w = worker_terms(params, b, wts, dist.get_rank(group))
            return collectives.coded_psum(terms, w, group)
        gsum, loss = None, torch.zeros((), dtype=torch.float32, device=_device_of(params))
        for w in range(R):
            terms, tw = worker_terms(params, b, wts, w)
            combined, l_w = collectives.weighted_sum(terms, tw)
            del terms
            if gsum is None:
                gsum = combined
            else:
                tree_map(lambda a, g: a.add_(g), gsum, combined)
            del combined
            loss = loss + l_w
        return gsum, loss

    def train_step(params, opt_state, batch_all, weights):
        gsum, loss = coded_grads(params, batch_all, weights)
        grads = tree_map(lambda g: g.div_(R), gsum)
        params, opt_state, metrics = adamw.apply(opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss / R
        return params, opt_state, metrics

    train_step.grads = coded_grads

    pats, ws = gradient_coding.weight_table(code, max_stragglers=max(1, K // 2), seed=seed)
    return train_step, code, (pats, ws)
