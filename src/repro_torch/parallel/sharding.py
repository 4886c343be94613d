"""Logical-axis -> mesh-axis sharding rules, the data mesh and the batch
spec (port of ``repro.parallel.sharding``).

Every parameter leaf carries a tuple of logical axis names, recorded at
init by the code that draws it (``models.common.ParamBuilder``,
``Model.init(..., with_axes=True)``).  This module turns those into specs
for a ``(data, model)`` mesh, with the reference's rules:

  * per-arch divisibility drives the rules: heads shard over 'model' when
    n_heads % model_size == 0, else attention falls back to row-parallel
    embed-dim sharding (phi4 24H, whisper 20H, llava 56H, rg 10H, xlstm 4H);
  * MoE expert tensors shard experts over 'model' (EP); very large archs
    (qwen3-235b) additionally FSDP-shard the expert ff dim over 'data';
  * optimizer state gets ZeRO-1 treatment: the largest dim a param leaves
    unsharded is sharded over 'data' when divisible;
  * per-tensor conflicts (two logical axes mapping to the same mesh axis)
    are resolved greedily left-to-right: e.g. (vocab->model, embed->model)
    keeps vocab sharded and replicates embed for that tensor only.

A spec is a tuple with one entry per dimension: a mesh axis name, a tuple
of names, or None (replicated), as a ``jax.sharding.PartitionSpec`` reads.
A mesh is anything with ``axis_names`` and a ``devices`` array
(:class:`~repro_torch.launch.mesh.HostMesh`, a stand-in with the
production sizes) or a ``torch.distributed`` ``DeviceMesh``.
:func:`param_shardings` and :func:`opt_state_shardings` give the specs, or,
on a ``DeviceMesh``, ``(mesh, placements)`` pairs: a spec entry ``"model"``
is ``Shard(dim)`` on the mesh dimension named ``model``, None
``Replicate()``.  ``parallel.tensor`` lays a tree out by them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..launch.mesh import HostMesh, _local_devices

__all__ = ["batch_spec", "cache_shardings", "data_mesh", "estimate_bytes", "make_rules",
           "mesh_shape", "named", "opt_state_shardings", "param_shardings", "placements_for",
           "spec_for_axes"]

PyTree = Any
AxisRule = Dict[str, Optional[str]]


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or a mesh with ``axis_names``
    and a ``devices`` array."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # torch.distributed DeviceMesh
        return dict(zip(names, (mesh.size(i) for i in range(len(names)))))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _map_axes(fn, axes_tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the axes tuples of ``axes_tree`` (and the matching leaves
    of ``rest``), keeping the tree's dicts and lists."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, *(r[k] for r in rest)) for k, v in axes_tree.items()}
    return type(axes_tree)(_map_axes(fn, v, *(r[i] for r in rest))
                           for i, v in enumerate(axes_tree))


def make_rules(cfg, mesh, opts=None) -> AxisRule:
    opts = opts or {}
    names = mesh_shape(mesh)
    model_n = names.get("model", 1)
    rules: AxisRule = {
        "layers": None,
        "head_dim": None,
        "conv": None,
    }
    heads_ok = _div(cfg.n_heads, model_n)
    rules["heads"] = "model" if heads_ok else None
    rules["kv_heads"] = "model" if _div(cfg.n_kv_heads, model_n) else None
    # Fallback when heads don't divide the model axis: either row-parallel
    # attention via the embed dim (default baseline), or replicate the
    # (small) attention params entirely and keep activations
    # collective-free (opts["attn_replicate"]).
    if not heads_ok and _div(cfg.d_model, model_n) and not opts.get("attn_replicate"):
        rules["embed"] = "model"
    else:
        rules["embed"] = None
    ff = cfg.moe.d_ff_expert if cfg.moe is not None else cfg.d_ff
    ff = ff or int(cfg.d_model * cfg.mlstm_proj_factor)
    rules["ff"] = "model" if _div(ff, model_n) else None
    if cfg.moe is not None and _div(cfg.moe.n_experts, model_n):
        rules["experts"] = "model"
        # FSDP the expert ff dim over 'data' when a model-only shard of the
        # params would blow past ~8 GB/device (qwen3-235b).
        if "data" in names:
            data_n = names["data"]
            if cfg.n_params() * 2 / max(model_n, 1) > 8e9 and _div(ff, data_n):
                rules["ff"] = "data"
    else:
        rules["experts"] = None
    rules["vocab"] = "model" if _div(cfg.vocab, model_n) else None
    w = cfg.lru_width or cfg.d_model
    rules["state"] = "model" if _div(w, model_n) else None
    return rules


def spec_for_axes(axes: Tuple[Optional[str], ...], rules: AxisRule) -> tuple:
    """Resolve one tensor's logical axes to a spec, dropping per-tensor
    duplicate mesh-axis assignments (greedy, left-to-right)."""
    used = set()
    out = []
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m is None or m in used:
            out.append(None)
        else:
            out.append(m)
            used.add(m)
    return tuple(out)


def placements_for(mesh, spec: Sequence) -> list:
    """DTensor placements on a ``DeviceMesh`` for a spec: for each mesh
    dimension, ``Shard(i)`` if entry ``i`` of the spec names it (alone or
    in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def named(mesh, spec: tuple):
    """The port's ``NamedSharding(mesh, spec)``: ``(mesh, placements)`` on
    a ``DeviceMesh``, the spec itself on a stand-in mesh."""
    return (mesh, placements_for(mesh, spec)) if _is_device_mesh(mesh) else tuple(spec)


_sharding = named


def param_shardings(mesh, axes_tree: PyTree, rules: AxisRule) -> PyTree:
    """A spec a leaf (``(mesh, placements)`` on a ``DeviceMesh``)."""
    return _map_axes(lambda a: _sharding(mesh, spec_for_axes(a, rules)), axes_tree)


def zero1_spec(axes, shape, rules: AxisRule, data_n: int) -> tuple:
    """ZeRO-1: the parameter's spec, plus its largest unsharded,
    data-divisible dimension over 'data' (the largest index on a tie)."""
    spec = list(spec_for_axes(axes, rules))
    if "data" not in spec and data_n > 1:
        cands = [(shape[i], i) for i in range(len(shape))
                 if spec[i] is None and _div(shape[i], data_n)]
        if cands:
            _, i = max(cands)
            spec[i] = "data"
    return tuple(spec)


def opt_state_shardings(mesh, axes_tree: PyTree, rules: AxisRule,
                        shapes_tree: PyTree) -> PyTree:
    """ZeRO-1: like the param sharding, plus shard the largest remaining
    unsharded dim over 'data' when divisible.  ``shapes_tree``: a shape
    (or a tensor) a leaf."""
    data_n = mesh_shape(mesh).get("data", 1)

    def one(axes, shape):
        return _sharding(mesh, zero1_spec(axes, tuple(getattr(shape, "shape", shape)), rules,
                                          data_n))

    return _map_axes(one, axes_tree, shapes_tree)


def data_mesh(devices: Optional[Sequence] = None) -> HostMesh:
    """1-D 'data' mesh over the given devices (default: every local card;
    raises without one).

    The Monte-Carlo engine's device-sharded batch runner
    (``core.engine.Engine(shard=True)``) splits its reps over it."""
    import torch

    devs = [torch.device(d) for d in devices] if devices is not None else _local_devices()
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return HostMesh(grid, ("data",))


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> tuple:
    """Shard the leading batch dim over ('pod','data') as divisibility
    allows; remaining dims replicated."""
    names = mesh_shape(mesh)
    axes = []
    if "pod" in names and "data" in names:
        if _div(batch, names["pod"] * names["data"]):
            axes = ["pod", "data"]
        elif _div(batch, names["data"]):
            axes = ["data"]
    elif "data" in names and _div(batch, names["data"]):
        axes = ["data"]
    # Normalize: a single mesh axis is a bare name, multiple axes a tuple:
    # consumers index bspec[0] and expect the bare-name form for one axis.
    first = None if not axes else axes[0] if len(axes) == 1 else tuple(axes)
    return (first, *([None] * extra_dims))


def _cache_spec(name: str, nd: int, shape, cfg, b_axis, rules: AxisRule, model_n: int) -> tuple:
    """One cache leaf's spec, in the port's per-layer layout: the
    reference's rule with its leading groups dimension dropped."""
    if name == "enc_out" and nd == 3:  # whisper encoder output (B, T, D)
        return (b_axis, None, None)
    if name in ("k", "v") and nd == 4:  # (B, Hkv, T, hd)
        if _div(cfg.n_kv_heads, model_n):
            return (b_axis, "model", None, None)
        if _div(cfg.head_dim_, model_n):
            return (b_axis, None, None, "model")
        return (b_axis, None, None, None)
    if name == "C" and nd == 4:  # mLSTM matrix state (B, H, dh, dh)
        return (b_axis, "model" if _div(cfg.n_heads, model_n) else None, None, None)
    if nd >= 1:
        spec = [b_axis] + [None] * (nd - 1)
        # shard a trailing state dim over model if divisible (rg-lru h)
        if name in ("h", "conv") and rules.get("state") == "model" and \
                _div(shape[-1], model_n):
            spec[-1] = "model"
        return tuple(spec)
    return ()


def cache_shardings(mesh, cfg, cache_tree: PyTree, batch: int, rules: AxisRule) -> PyTree:
    """Decode caches: batch over ('pod','data'); KV heads over 'model' when
    divisible, else head_dim over 'model' (qwen3 kv=4, granite kv=1).

    The port's caches are per layer (``models.transformer.init_lm_caches``):
    attention {k, v}: (B, Hkv, T, hd) and its ``pos`` (an int); recurrent
    states (B, ...), whose widest state dim shards over 'model' when the
    rules allow.  The reference's stacked caches carry a leading groups
    dimension, which its specs leave whole; the port's specs are its specs
    without that entry.  A leaf that is not a tensor (``pos``, ``ring``)
    gets ``()``; a None subtree stays None."""
    model_n = mesh_shape(mesh).get("model", 1)
    b_axis = batch_spec(mesh, batch, extra_dims=0)[0]

    def walk(node, name):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        shape = tuple(getattr(node, "shape", ()))
        return _sharding(mesh, _cache_spec(name, len(shape), shape, cfg, b_axis, rules,
                                           model_n))

    return walk(cache_tree, "")


def estimate_bytes(tree: PyTree) -> int:
    """The bytes of a tree's tensors (their global shapes, for DTensors)."""
    total = 0
    for x in _leaves(tree):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            itemsize = getattr(x.dtype, "itemsize", None) or np.dtype(str(x.dtype)).itemsize
            total += int(np.prod(tuple(x.shape))) * itemsize
    return total


def _leaves(tree: PyTree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
