"""Dry run on the production meshes: one rank's train step of every
(architecture x shape) cell, counted without a card (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 forced XLA host devices
and reads memory, FLOPs, bytes and collective wire from the compile.  The
port runs rank 0's step of the same cell, eagerly:

* on shape-only tensors: shapes and types, no storage.  The cells step
  ``meta`` tensors, on any host.  :func:`count_step` with
  ``device="cuda"`` steps fake CUDA tensors instead
  (``torch._subclasses.fake_tensor.FakeTensorMode``: the card's device in
  every branch, 3-4x slower to dispatch, and only where PyTorch is built
  with CUDA, whose autograd needs its device guard).  Both dispatch the
  ops a step on the card runs: :func:`check_rank` holds a real step on
  the card to both;
* over a ``fake`` process group of 512 ranks
  (:func:`repro_torch.launch.mesh.start_fake_world`), whose collectives
  move nothing, with the mesh of :func:`~repro_torch.launch.mesh.make_production_mesh`;
* counting FLOPs and bytes with ``utils.trace.StepCosts`` (K4 by its
  shape-only route, which counts each call as a launch,
  ``kernels/flash_attention``),
  collectives with ``parallel.tensor.COUNTS`` and the live bytes of the
  step's storages with :class:`LiveBytes`.

Nothing is allocated, so no cell needs a card.

Methodology.  Eager PyTorch rolls nothing, but a full-depth step (94
layers x 8 microbatches) on fake tensors is too many Python dispatches.  A
step's FLOPs, bytes, wire and calls are exactly bilinear in the number of
groups G and of microbatches M: per microbatch the embedding and head plus
G groups; the fp32 accumulator's adds once per microbatch after the first;
the gradient all-reduce and AdamW once per step, affine in G.  So each
cell is probed at G, M in {1, 2} x {1, 2} (``_shrink``) and every count
assembled at (L groups, n_micro) by bilinear extrapolation; the optimizer
and its all-reduce are counted, not estimated.  ``once_wire`` is the wire at M = 0: the
collectives outside the microbatch loop.  The peak live bytes are
extrapolated in G the same way, from the probes at the largest M.

xLSTM's mLSTM and sLSTM cells loop over time in Python, so at T 4096 a
probe would be millions of dispatches.  Their cells are probed also at
three short text lengths (``TIME_PROBE``) and extrapolated in T.  Every
count is a polynomial of degree at most 2 in T, which three lengths fit
exactly: each step's ops are the same, but the backward of a step's slice
``x[:, t]`` writes a gradient of the whole sequence, so the bytes grow as
T^2 (FLOPs and ops as T).  The peak is affine in T from the two longest
probes (mLSTM's recompute holds each step's matrix state).  Every cell thus counts every time step:
``time_scan_undercount`` is false everywhere.

The serve shapes (prefill, decode) wait for slice C6b of the port.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b \\
      --shape train_4k --mesh single

Results are cached as JSON under ``build/repro_torch/dryrun/`` (``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import pathlib
import time
import traceback
import weakref
from fractions import Fraction
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from .. import _device
from ..configs import ARCH_IDS, SHAPES, applicable, get_config
from ..kernels.flash_attention.ops import set_chunk_opts
from ..models.common import tree_map
from ..models.model import build_model
from ..models.moe import set_moe_opts
from ..optim import adamw
from ..parallel import sharding as shd
from ..parallel import tensor as tp
from ..runtime.train_loop import make_train_step
from ..utils import roofline as rf
from ..utils import trace
from . import mesh as mesh_mod
from . import specs as specs_mod

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun"

N_MICRO = {"default": 8}
OPTS = ("remat_policy", "n_micro", "moe_constrain")
WORLD = 512
TIME_PROBE = (8, 16, 24)  # text lengths of the probes of a cell with a loop over time
TIME_KINDS = ("mlstm", "slstm")


# ------------------------------------------------------------ memory a device


def _spec_div(sh, mesh) -> int:
    """How many pieces a spec (entries a mesh axis, a tuple of them, or
    None) cuts a tensor into on ``mesh``."""
    names = shd.mesh_shape(mesh)
    div = 1
    for ax in sh:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            div *= names.get(a, 1)
    return div


def _pairs(structs, shards) -> list:
    """(struct, sharding) of every leaf, walked by ``structs``' keys."""
    if isinstance(structs, dict):
        return [x for k, v in structs.items() for x in _pairs(v, shards[k])]
    if isinstance(structs, (list, tuple)) and not hasattr(structs, "shape"):
        return [x for i, v in enumerate(structs) for x in _pairs(v, shards[i])]
    return [(structs, shards)]


def _sharded_elems(struct_tree, shard_tree, mesh) -> float:
    total = 0.0
    for st, sh in _pairs(struct_tree, shard_tree):
        n = float(np.prod(tuple(st.shape))) if len(st.shape) else 1.0
        total += n / _spec_div(sh, mesh)
    return total


def _sharded_bytes(struct_tree, shard_tree, mesh) -> float:
    total = 0.0
    for st, sh in _pairs(struct_tree, shard_tree):
        n = float(np.prod(tuple(st.shape))) if len(st.shape) else 1.0
        total += n * st.element_size() / _spec_div(sh, mesh)
    return total


def _dp_size(mesh) -> int:
    names = shd.mesh_shape(mesh)
    return names.get("data", 1) * names.get("pod", 1)


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive, and their peak, while it is active:
    each op's outputs' storages are counted once, from the op that makes
    them until the last tensor on them dies.  :meth:`hold` counts a tree
    made before (the placed state).  Fake storages have their real
    sizes, so this is the step's memory on the card, less the allocator's
    rounding."""

    def __init__(self):
        super().__init__()
        self._seen = WeakIdKeyDictionary()
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _add(self, t: torch.Tensor) -> None:
        if tp.is_dtensor(t):
            t = t.to_local()
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold(self, tree) -> None:
        for t in _pytree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.hold(out)
        return out


# ------------------------------------------------------------------ probing


def _shrink(cfg, n_groups: int):
    """Variant config with n_groups repeats of the block pattern (and, for
    enc-dec, a matching encoder depth)."""
    kw = dict(n_layers=n_groups * cfg.pattern_period)
    if cfg.enc_dec:
        kw["n_enc_layers"] = n_groups
    return dataclasses.replace(cfg, **kw)


def _fake_state(model, mesh, rules, shape, n_micro, device):
    """Rank 0's placed parameters, ZeRO-1 moments and batch, fake: the
    parameters' local shards (``parallel.sharding`` rules), zero moments
    laid out by ``opt_state_shardings`` and a (n_micro, mb, T) batch."""
    from torch.distributed.tensor import DTensor

    meta, axes = specs_mod.params_and_axes_struct(model)
    p_sh = tp.shardings_like(shd.param_shardings(mesh, axes, rules), meta)

    def place(x, s):
        dm, placements = s
        local = torch.empty(tp.local_shape(x.shape, dm, placements), dtype=x.dtype,
                            device=device)
        return DTensor.from_local(local, dm, list(placements), run_check=False, shape=x.shape,
                                  stride=x.stride())

    params = tree_map(place, meta, p_sh)
    opt = adamw.init(params, shd.opt_state_shardings(mesh, axes, rules, meta))
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
             for k, v in specs_mod.batch_struct(model.cfg, shape, n_micro).items()}
    return params, opt, batch


def _shape_only_mode(device: torch.device):
    """Fake tensors on a real device type; nothing for ``meta``."""
    if device.type == "meta":
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def count_step(cfg, shape, n_micro: int, mesh, rules, opts=None, device="meta") -> Dict:
    """Rank 0's train step of ``cfg`` at ``shape`` with ``n_micro``
    microbatches of ``shape.global_batch // n_micro`` rows on shape-only
    tensors (``meta``, or fake tensors on ``device``): FLOPs, bytes and
    aten ops (``StepCosts``), each kernel's calls, FLOPs and bytes, each
    kind of collective's calls, bytes and wire, and the peak live bytes,
    the placed state counted."""
    opts = opts or {}
    device = torch.device(device)
    model = build_model(cfg, use_kernel=True, remat=True,
                        remat_policy=opts.get("remat_policy", "full"))
    with _shape_only_mode(device):
        params, opt, batch = _fake_state(model, mesh, rules, shape, n_micro, device)
        step = make_train_step(model, adamw.AdamWConfig(), n_micro, pre_shaped=True,
                               device=device, mesh=mesh)
        live = LiveBytes()
        live.hold((params, opt, batch))
        tp.reset_counts()
        with live, trace.StepCosts() as sc:
            step(params, opt, batch)
    return _counts(sc, peak_bytes=live.peak)


def _counts(sc: trace.StepCosts, **extra) -> Dict:
    """A step's counts, flat: its ``StepCosts``, each kernel's, each kind of
    collective's (``parallel.tensor.COUNTS``, then reset) and ``extra``."""
    out = {"flops": sc.flops, "bytes": sc.bytes, "aten_ops": sc.aten_ops, **extra}
    for name, k in sc.by_kernel.items():
        for f in ("calls", "flops", "bytes"):
            out[f"kernel/{name}/{f}"] = k[f]
    for kind, (calls, nbytes, wb) in tp.COUNTS.items():
        out[f"coll/{kind}/calls"], out[f"coll/{kind}/bytes"] = calls, nbytes
        out[f"coll/{kind}/wire"] = wb
    out["wire"] = sum(tp.wire().values())
    tp.reset_counts()
    return out


def check_rank(arch: str, multi_pod: bool, shape_name: str = "train_4k", n_groups: int = 1,
               device="cuda", seed: int = 0) -> Dict:
    """One production rank stepped for real beside its shape-only counts:
    rank 0 of the fake world on ``device`` (default ``cuda``; raises
    without a card unless ``cpu``), the cell's config at full width and
    ``n_groups`` groups with the cell's rules and ``n_micro``, parameters
    drawn from ``seed`` and placed by the rules, one train step (the fake
    backend's collectives move nothing, so its values mean nothing).
    Returns the counts of that step (``real``: ``StepCosts``, the
    collectives, the peak of ``torch.cuda.max_memory_allocated`` over the
    step with the placed state in it, and K4's ``launches``), and of the
    same step on ``meta`` tensors (``meta``) and, on a card, on fake CUDA
    tensors (``fake``)."""
    dev = _device.resolve(device)
    shape = SHAPES[shape_name]
    full = cell_config(arch)
    cfg = _shrink(full, n_groups)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    mesh = production_mesh(multi_pod)
    rules = shd.make_rules(full, mesh)
    n_micro = cell_n_micro(arch, shape, mesh)
    out = {"n_micro": n_micro, "rules": dict(rules),
           "meta": count_step(cfg, shape, n_micro, mesh, rules)}
    if dev.type == "cuda":
        out["fake"] = count_step(cfg, shape, n_micro, mesh, rules, device=dev)
    out["real"] = _real_step(cfg, shape, n_micro, mesh, rules, dev, seed)
    return out


def _real_step(cfg, shape, n_micro, mesh, rules, dev, seed) -> Dict:
    from ..kernels.flash_attention import kernel as k4

    model = build_model(cfg, use_kernel=dev.type == "cuda", remat=True)
    params, axes = model.init(seed, device=dev, with_axes=True)
    params = tp.place_tree(params, shd.param_shardings(mesh, axes, rules))
    opt = adamw.init(params, shd.opt_state_shardings(mesh, axes, rules, params))
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {}
    for k, v in specs_mod.batch_struct(cfg, shape, n_micro).items():
        if v.dtype == torch.int32:
            batch[k] = torch.randint(0, cfg.vocab, tuple(v.shape), generator=gen, device=dev,
                                     dtype=torch.int32)
        else:
            batch[k] = torch.randn(tuple(v.shape), generator=gen, device=dev).to(v.dtype)
    step = make_train_step(model, adamw.AdamWConfig(), n_micro, pre_shaped=True, device=dev,
                           mesh=mesh)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    before = (k4.flash_attention_cuda.launches, k4.flash_attention_bwd_cuda.launches)
    tp.reset_counts()
    live = LiveBytes()
    live.hold((params, opt, batch))
    t0 = time.perf_counter()
    with live, trace.StepCosts() as sc:
        step(params, opt, batch)
    if cuda:
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    return _counts(sc, peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None,
                   live_peak_bytes=live.peak, step_s=secs,
                   launches={"flash_attention": k4.flash_attention_cuda.launches - before[0],
                             "flash_attention_bwd": k4.flash_attention_bwd_cuda.launches
                             - before[1]})


def _time_scanned(cfg) -> bool:
    return any(b in TIME_KINDS for b in cfg.block_pattern)


def _weights(points: Sequence[int], x: int) -> List[Fraction]:
    """Lagrange weights of ``points`` at ``x``: exact for a polynomial of
    degree below ``len(points)``."""
    out = []
    for i, a in enumerate(points):
        w = Fraction(1)
        for j, b in enumerate(points):
            if j != i:
                w *= Fraction(x - b, a - b)
        out.append(w)
    return out


def _extrapolate(points: Dict[tuple, Dict], axes: Sequence[Sequence[int]],
                 at: Sequence[int], keys) -> Dict[str, float]:
    """Each of ``keys`` at ``at`` from its values at the grid ``points``
    (coordinates -> counts) over ``axes``, by Lagrange interpolation along
    each axis, in exact rational arithmetic."""
    ws = [_weights(a, x) for a, x in zip(axes, at)]
    out = {}
    for key in keys:
        total = Fraction(0)
        for corner in itertools.product(*[range(len(a)) for a in axes]):
            w = Fraction(1)
            for wa, c in zip(ws, corner):
                w *= wa[c]
            coord = tuple(a[c] for a, c in zip(axes, corner))
            total += w * Fraction(points[coord].get(key, 0))
        out[key] = float(total)
    return out


def probe_cell(cfg, shape, n_micro: int, mesh, rules, opts=None) -> Dict:
    """Every count of the cell at (``cfg.n_groups`` groups, ``n_micro``)
    assembled from probes (the module's docstring): ``totals`` (counts,
    ``peak_bytes``, ``once_wire``), the probes themselves, and their
    axes."""
    g_axis, m_axis = (1, 2), (1, 2)
    t_axis = TIME_PROBE if _time_scanned(cfg) else (shape.seq_len,)
    points = {}
    for g, m, t in itertools.product(g_axis, m_axis, t_axis):
        sh = dataclasses.replace(shape, seq_len=t, global_batch=shape.global_batch // n_micro * m)
        points[(g, m, t)] = count_step(_shrink(cfg, g), sh, m, mesh, rules, opts)
    keys = sorted(set().union(*points.values()) - {"peak_bytes"})
    axes = (g_axis, m_axis, t_axis)
    at = (cfg.n_groups, n_micro, shape.seq_len)
    totals = _extrapolate(points, axes, at, keys)
    # the peak from the probes at the cell's M (two microbatches where it
    # has more), affine in G and in T (the two longest probes: what the
    # step holds at its peak grows by the same bytes a step once the loop's
    # saved states dominate it); the wire outside the microbatch loop at
    # M = 0
    m_peak, t_peak = min(n_micro, 2), t_axis[-2:]
    peak_pts = {(g, t): {"peak_bytes": v["peak_bytes"]} for (g, m, t), v in points.items()
                if m == m_peak and t in t_peak}
    totals["peak_bytes"] = _extrapolate(peak_pts, (g_axis, t_peak),
                                        (cfg.n_groups, shape.seq_len), ["peak_bytes"])[
        "peak_bytes"]
    totals["once_wire"] = _extrapolate(points, axes, (cfg.n_groups, 0, shape.seq_len),
                                       ["wire"])["wire"]
    return {"totals": totals, "axes": {"groups": list(g_axis), "n_micro": list(m_axis),
                                       "seq_len": list(t_axis)},
            "points": {f"g{g}_m{m}_t{t}": v for (g, m, t), v in points.items()}}


# ------------------------------------------------------------------- cells

_MESHES: Dict[bool, object] = {}


def production_mesh(multi_pod: bool):
    """The production mesh over the fake world (started on first use)."""
    if multi_pod not in _MESHES:
        mesh_mod.start_fake_world(WORLD)
        _MESHES[multi_pod] = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    return _MESHES[multi_pod]


def cell_n_micro(arch: str, shape, mesh, opts=None) -> int:
    """The reference's microbatch count: ``N_MICRO`` (or ``opts``), halved
    while a microbatch does not split over the data-parallel ranks."""
    opts = opts or {}
    n_micro = opts.get("n_micro") or N_MICRO.get(arch, N_MICRO["default"])
    dp = _dp_size(mesh)
    while (shape.global_batch // n_micro) % dp and n_micro > 1:
        n_micro //= 2
    return n_micro


def cell_config(arch: str):
    """The dry run's config: the reference's, in bfloat16."""
    return get_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")


def state_bytes_est(cfg, mesh, rules) -> Dict[str, float]:
    """The full-depth state a device holds by the rules, from the shapes
    alone (the reference's ``_sharded_bytes``): ``param_bytes_per_device_est``
    and the fp32 moments' ``opt_bytes_per_device_est`` (ZeRO-1).  ``mesh``:
    a ``DeviceMesh`` or a stand-in."""
    stand_in = _StandIn(mesh) if hasattr(mesh, "mesh_dim_names") else mesh
    params, axes = specs_mod.params_and_axes_struct(build_model(cfg))
    o_spec = shd.opt_state_shardings(stand_in, axes, rules, params)
    return {"param_bytes_per_device_est": _sharded_bytes(
                params, shd.param_shardings(stand_in, axes, rules), stand_in),
            "opt_bytes_per_device_est": 2 * 4 * _sharded_elems(params, o_spec, stand_in)}


class _StandIn:
    """A mesh's axis names and sizes (``axis_names``, a ``devices``
    array): the specs the reference would read on it."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.devices = np.empty(tuple(mesh.size(i) for i in range(mesh.ndim)), dtype=object)


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             opts=None, cfg=None) -> Dict:
    """One cell's record (the reference's keys where they have a
    counterpart; ``trace_s`` for its ``compile_s``).  ``opts``: the knobs
    the port has, ``remat_policy`` ("full" or "dots"), ``n_micro`` and
    ``moe_constrain`` (the reference's GSPMD hint, recorded: it moves
    nothing in an eager step); any other key raises.  ``cfg`` replaces the
    arch's config (a smaller one, in tests)."""
    opts = dict(opts or {})
    bad = sorted(set(opts) - set(OPTS))
    if bad:
        raise ValueError(f"dry-run opts {bad} have no counterpart in the port; it takes {OPTS}")
    shape = SHAPES[shape_name]
    cfg = cell_config(arch) if cfg is None else cfg
    skip = applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "skip", "skip_reason": skip}
    if skip is not None:
        return result
    if shape.kind != "train":
        raise NotImplementedError(
            f"the dry run's {shape.kind} cells ({shape_name}) wait for slice C6b of the port "
            "(the caches on the mesh); the train cells run")

    t0 = time.time()
    mesh = production_mesh(multi_pod)
    n_dev = mesh.size()
    rules = shd.make_rules(cfg, mesh, opts)
    set_moe_opts(constrain=bool(opts.get("moe_constrain")))
    set_chunk_opts(chunk=1024, unroll=False)
    n_micro = cell_n_micro(arch, shape, mesh, opts)

    probe = probe_cell(cfg, shape, n_micro, mesh, rules, opts)
    tot = probe["totals"]
    roof = rf.Roofline(
        compute_s=tot["flops"] / rf.BF16_FLOPS, memory_s=tot["bytes"] / rf.HBM_BW,
        collective_s=tot["wire"] / rf.NVLINK_BW, flops=tot["flops"], hbm_bytes=tot["bytes"],
        wire_bytes=tot["wire"], model_flops=rf.model_flops(cfg, shape, n_dev), peak="bf16")
    mem = {
        **state_bytes_est(cfg, mesh, rules),
        "peak_bytes_per_device": tot["peak_bytes"],
        "peak_source": "live storages of one step on shape-only tensors (dryrun.LiveBytes), "
                       "the placed state included; extrapolated in groups",
    }
    if _time_scanned(cfg):
        mem["peak_source"] += (" and from the two longest short probes in T: an underestimate "
                               "wherever the loop's saved states do not yet set their peak")
    kinds = sorted({k.split("/")[1] for k in tot if k.startswith("coll/")})
    colls = {k: {f: tot[f"coll/{k}/{f}"] for f in ("calls", "bytes", "wire")} for k in kinds}
    # K4's two kernels always listed: an arch without attention calls them 0 times
    kernels = sorted({k.split("/")[1] for k in tot if k.startswith("kernel/")}
                     | {"flash_attention", "flash_attention_bwd"})
    by_kernel = {k: {f: tot.get(f"kernel/{k}/{f}", 0) for f in ("calls", "flops", "bytes")}
                 for k in kernels}
    result.update(
        status="ok",
        trace_s=round(time.time() - t0, 1),
        n_devices=n_dev,
        n_micro=n_micro,
        time_scan_undercount=False,
        memory=mem,
        collectives=colls,
        once_wire=tot["once_wire"],
        by_kernel=by_kernel,
        aten_ops=tot["aten_ops"],
        probe=probe,
        roofline=roof.to_dict(),
        rules=dict(rules),
    )
    if verbose:
        frac = roof.roofline_fraction
        print(f"  ok in {result['trace_s']}s | flops/dev={roof.flops:.3e} "
              f"| hbm={roof.hbm_bytes:.3e} | wire={roof.wire_bytes:.3e} "
              f"| dominant={roof.dominant} | roofline_frac="
              f"{None if frac is None else round(frac, 4)}", flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--out", default=str(OUT_DIR), help="where the cells' JSON goes")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    arches = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    n_ok = n_skip = n_fail = 0
    for arch in arches:
        for shape in shapes:
            for mesh_name in meshes:
                tag = f"{arch}__{shape}__{mesh_name}"
                out = out_dir / f"{tag}.json"
                if out.exists() and not args.force:
                    prev = json.loads(out.read_text())
                    print(f"[cached] {tag}: {prev['status']}")
                    n_ok += prev["status"] == "ok"
                    n_skip += prev["status"] == "skip"
                    n_fail += prev["status"] == "fail"
                    continue
                print(f"[run] {tag}", flush=True)
                try:
                    res = run_cell(arch, shape, mesh_name == "multi")
                except NotImplementedError as e:
                    res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "skip", "skip_reason": str(e)}
                except Exception as e:  # a cell's failure is its record
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "fail", "error": f"{type(e).__name__}: {e}"}
                out.write_text(json.dumps(res, indent=1, default=str))
                n_ok += res["status"] == "ok"
                n_skip += res["status"] == "skip"
                n_fail += res["status"] == "fail"
                if res["status"] == "skip":
                    print(f"  skip: {res['skip_reason']}")
                elif res["status"] == "fail":
                    print(f"  FAIL: {res['error']}")
    print(f"\ndry-run complete: {n_ok} ok / {n_skip} skip / {n_fail} fail")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
