"""The dry run's train cells (``repro_torch.launch.specs``,
``repro_torch.launch.dryrun``; slice C6a) against the reference.

* ``specs``' structs and shardings equal the reference's for every arch on
  both production meshes (the stand-in meshes of
  ``tests/test_torch_sharding.py``; the reference's ``NamedSharding`` reads
  back its spec), and ``param_bytes_per_device_est`` equals the
  reference's ``_sharded_bytes`` formula on the reference's own structs and
  specs, exactly.  The reference's trees are ``jax.eval_shape`` of its
  full-size init: nothing is drawn.
* The dry run's assembly: at a 3-group smoke config the counts assembled
  from the 1- and 2-group probes (and 1 and 2 microbatches) equal a direct
  count of the whole step exactly, and the extrapolated peak is within 2%
  of the tracked one; xLSTM's extrapolation in the text length is exact
  (quadratic: three lengths).
* K4's shape-only route (fake and ``meta`` tensors): the kernel's shapes
  and counts, nothing built or launched.
* The MoE's ``bin_counts`` (a ``scatter_add_``, shape-static) gives the
  block the outputs, aux loss and drops of ``torch.bincount``, bit for bit.
* A serve shape is refused naming slice C6b; a smoke cell runs end to end
  on both production meshes.

The fake world (512 ranks of the ``fake`` backend) lives for this module
only: its fixture destroys it.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.kernels.flash_attention import kernel as k4
from repro_torch.kernels.flash_attention import ops as k4_ops
from repro_torch.launch import dryrun
from repro_torch.launch import specs
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.parallel import sharding as shd
from repro_torch.utils import trace


class FakeMesh:
    """Stand-in with the production axis sizes (no real devices needed)."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


MESHES = {"single": FakeMesh((16, 16), ("data", "model")),
          "multi": FakeMesh((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def world():
    """The fake world of the production meshes, destroyed after the module
    (the rest of a pytest worker's files must not see a process group)."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()
    dryrun._MESHES.clear()


@pytest.fixture(scope="module")
def reference_specs():
    from repro.launch import specs as specs_jax
    from repro.parallel import sharding as shd_jax

    mp = pytest.MonkeyPatch()
    for mod in (shd_jax, specs_jax):
        mp.setattr(mod, "NamedSharding", lambda mesh, spec: spec)
    yield shd_jax
    mp.undo()


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's dry-run config, its model, and its full-size param
    structs and axes."""
    from repro.configs import get_config as get_config_jax
    from repro.launch import specs as specs_jax
    from repro.models import build_model as build_model_jax

    cfg = get_config_jax(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    model = build_model_jax(cfg)
    structs, axes = specs_jax.params_and_axes_struct(model)
    return cfg, model, structs, axes


def _reference_sharded_bytes(struct_tree, shard_tree, mesh) -> float:
    """The reference's ``dryrun._sharded_bytes`` formula on its trees (its
    module sets XLA's host device count when imported, so it is not)."""
    import jax

    names = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0.0
    structs = jax.tree.leaves(struct_tree)
    shards = jax.tree.leaves(shard_tree, is_leaf=lambda x: isinstance(x, tuple))
    for st, spec in zip(structs, shards):
        div = 1
        for ax in spec:
            for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
                div *= names.get(a, 1)
        n = float(np.prod(st.shape)) if st.shape else 1.0
        total += n * st.dtype.itemsize / div
    return total


def _spec(s):
    return tuple(s)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_param_bytes_equal_the_reference(reference_specs, arch, mesh_name):
    from repro.launch import specs as specs_jax

    shd_jax, mesh = reference_specs, MESHES[mesh_name]
    cfg_j, model_j, structs_j, axes_j = _reference(arch)
    cfg = dryrun.cell_config(arch)
    shape = SHAPES["train_4k"]
    assert specs.text_len(cfg, shape.seq_len) == specs_jax.text_len(cfg_j, shape.seq_len)

    # the batch: structs and shardings
    b, bj = specs.batch_struct(cfg, shape, 8), specs_jax.batch_struct(cfg_j, shape, 8)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in b.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in bj.items()}
    assert {k: _spec(v) for k, v in specs.batch_shardings(mesh, b).items()} == {
        k: _spec(v) for k, v in specs_jax.batch_shardings(mesh, bj).items()}

    # the parameters: the same elements and bytes, and a device's bytes by
    # the rules equal the reference's formula on its own structs and specs
    rules = shd.make_rules(cfg, mesh)
    assert rules == shd_jax.make_rules(cfg_j, mesh)
    params, _ = specs.params_and_axes_struct(build_model(cfg))
    import jax

    assert sum(p.numel() * p.element_size() for p in jax.tree.leaves(params)) == sum(
        int(np.prod(s.shape)) * s.dtype.itemsize for s in jax.tree.leaves(structs_j))
    want = _reference_sharded_bytes(structs_j, shd_jax.param_shardings(mesh, axes_j, rules),
                                    mesh)
    assert dryrun.state_bytes_est(cfg, mesh, rules)["param_bytes_per_device_est"] == want

    # serving's structs and shardings (slice C6b's inputs)
    for name in ("prefill_32k", "decode_32k"):
        sh = SHAPES[name]
        tok, cache, emb = specs.serve_structs(build_model(cfg), cfg, sh)
        tok_j, cache_j, emb_j = specs_jax.serve_structs(model_j, cfg_j, sh)
        assert tuple(tok.shape) == tuple(tok_j.shape)
        assert (emb is None) == (emb_j is None)
        assert emb is None or tuple(emb.shape) == tuple(emb_j.shape)
        ts, _, es = specs.serve_shardings(mesh, cfg, sh, cache, rules)
        ts_j, _, es_j = specs_jax.serve_shardings(mesh, cfg_j, sh, cache_j, rules)
        assert (_spec(ts), _spec(es)) == (_spec(ts_j), _spec(es_j))
        # the buffers hold the same bytes (the port's cross_kv comes at
        # prefill; its positions are ints, the reference's (groups,) arrays)
        if cfg.enc_dec:
            cache_j = cache_j["dec"]
        nbytes = sum(x.numel() * x.element_size() for x in jax.tree.leaves(cache)
                     if isinstance(x, torch.Tensor) and x.dim() > 1)
        assert nbytes == sum(int(np.prod(x.shape)) * x.dtype.itemsize
                             for x in jax.tree.leaves(cache_j) if x.ndim > 1)


# ---- the assembly ----------------------------------------------------------

EXACT = ("flops", "bytes", "wire", "aten_ops")


def _smoke(arch, n_groups):
    cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    return dryrun._shrink(cfg, n_groups)


@pytest.mark.parametrize("n_micro", [2, 3])
def test_assembled_counts_equal_a_direct_count(world, n_micro):
    """mistral-nemo smoke at 3 groups on the (2, 16, 16) mesh, one row a
    data-parallel rank a microbatch: every assembled count (FLOPs, bytes,
    wire, aten ops, each kernel's and each collective's) is the direct
    count's, exactly; the peak within 2%."""
    cfg = _smoke("mistral-nemo-12b", 3)
    mesh = dryrun.production_mesh(True)
    rules = shd.make_rules(cfg, mesh)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=32 * n_micro)
    got = dryrun.probe_cell(cfg, shape, n_micro, mesh, rules)["totals"]
    want = dryrun.count_step(cfg, shape, n_micro, mesh, rules)
    for key in sorted(set(want) - {"peak_bytes"}):
        assert got[key] == want[key], key
    assert set(got) - {"peak_bytes", "once_wire"} == set(want) - {"peak_bytes"}
    assert want["kernel/flash_attention/calls"] == 2 * cfg.n_layers * n_micro  # remat: twice
    assert abs(got["peak_bytes"] / want["peak_bytes"] - 1) <= 0.02
    # the wire outside the microbatch loop: the step's all-reduce, the norm's
    # and ZeRO-1's gathers
    once = sum(want[k] for k in want if k.endswith("/wire") and k.split("/")[1] in (
        "data_all_reduce", "norm_all_reduce", "zero1_param_gather"))
    assert got["once_wire"] == pytest.approx(once, rel=1e-12)


def test_time_extrapolation_is_exact_for_xlstm(world):
    """xLSTM smoke (1 group) at T 16 from its counts at three shorter
    lengths (the cells' probes take ``TIME_PROBE``'s): every count is the
    direct count's.  Its bytes grow as T^2 (the backward of each step's
    slice writes a whole-sequence gradient), so two lengths would not do."""
    cfg = _smoke("xlstm-350m", 1)
    mesh = dryrun.production_mesh(False)
    rules = shd.make_rules(cfg, mesh)

    def count(t):
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=t, global_batch=16)
        return dryrun.count_step(cfg, shape, 1, mesh, rules)

    ts = (4, 8, 12)
    probes = {(t,): count(t) for t in ts}
    got = dryrun._extrapolate(probes, [ts], [16], EXACT)
    want = count(16)
    for key in EXACT:
        assert got[key] == want[key], key
    two = dryrun._extrapolate({p: probes[p] for p in list(probes)[:2]}, [ts[:2]], [16],
                              ["bytes"])
    assert two["bytes"] < want["bytes"]


# ---- K4's shape-only route -------------------------------------------------

def _no_card(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the shape-only route reached the card")

    for name in ("bind", "launch"):
        monkeypatch.setattr(k4._nvcc, name, refuse)
    monkeypatch.setattr(k4, "_sm_count", refuse)
    monkeypatch.setattr(k4, "_split_scratch", refuse)


@pytest.mark.parametrize("kind", ["meta", "fake-cuda"])
def test_k4_shape_only_route_counts_and_never_launches(monkeypatch, kind):
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    _no_card(monkeypatch)
    B, Hq, Hkv, T, D = 2, 4, 2, 96, 64
    dev = "meta" if kind == "meta" else "cuda"
    mode = contextlib.nullcontext() if kind == "meta" else FakeTensorMode()
    launches = (k4.flash_attention_cuda.launches, k4.flash_attention_bwd_cuda.launches)
    with mode, trace.StepCosts() as sc:
        q = torch.empty(B, Hq, T, D, dtype=torch.bfloat16, device=dev)
        k = torch.empty(B, Hkv, T, D, dtype=torch.bfloat16, device=dev)
        lse = torch.empty(B, Hq, T, dtype=torch.float32, device=dev)
        out = k4.flash_attention_cuda(q, k, k, window=32, softcap=50.0, lse=lse)
        dq, dk, dv = k4.flash_attention_bwd_cuda(q, k, k, out, out, lse, window=32,
                                                 softcap=50.0)
    assert (tuple(out.shape), out.dtype, out.device.type) == ((B, Hq, T, D), q.dtype, dev)
    assert [tuple(t.shape) for t in (dq, dk, dv)] == [(B, Hq, T, D), (B, Hkv, T, D)] * 1 + [
        (B, Hkv, T, D)]
    assert (k4.flash_attention_cuda.launches, k4.flash_attention_bwd_cuda.launches) == launches
    fwd = k4.attention_costs(B, Hq, Hkv, T, D, q_offset=0, tk_valid=T, causal=True, window=32,
                             elem=2, lse=True)
    bwd = k4.attention_bwd_costs(B, Hq, Hkv, T, T, D, q_offset=0, tk_valid=T, causal=True,
                                 window=32, elem=2)
    assert dict(sc.by_kernel["flash_attention"]) == {"calls": 1, "flops": fwd[0],
                                                      "bytes": fwd[1]}
    assert dict(sc.by_kernel["flash_attention_bwd"]) == {"calls": 1, "flops": bwd[0],
                                                          "bytes": bwd[1]}


def test_meta_attention_takes_the_kernel_route_with_its_backward(monkeypatch):
    """``ops.flash_attention(use_kernel=True)`` on meta tensors that need a
    gradient goes through ``FlashAttentionFn``: one forward, one backward
    counted; a CPU tensor with storage still refuses the kernel route."""
    _no_card(monkeypatch)
    q = torch.empty(1, 2, 16, 8, device="meta", requires_grad=True)
    with trace.StepCosts() as sc:
        k4_ops.flash_attention(q, q, q, use_kernel=True).sum().backward()
    assert sc.by_kernel["flash_attention"]["calls"] == 1
    assert sc.by_kernel["flash_attention_bwd"]["calls"] == 1
    with pytest.raises(ValueError, match="use_kernel=True"):
        k4_ops.flash_attention(torch.zeros(1, 2, 16, 8), torch.zeros(1, 2, 16, 8),
                               torch.zeros(1, 2, 16, 8), use_kernel=True)


# ---- the MoE's counts --------------------------------------------------------

def test_bin_counts_keep_the_moe_block_bitwise(monkeypatch):
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 9, size=(300,)))
    assert torch.equal(moe.bin_counts(ids, 9), torch.bincount(ids, minlength=9))
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b", smoke=True))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    params = build_model(cfg).init(0, device="cpu")["blocks"][0]["mlp"]
    x = torch.as_tensor(rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32))
    moe.set_moe_opts(count_drops=True)
    try:
        runs = []
        for counter in (moe.bin_counts,
                        lambda i, n: torch.bincount(i.reshape(-1), minlength=n)):
            monkeypatch.setattr(moe, "bin_counts", counter)
            moe.moe_block.dropped = 0
            out, aux = moe.moe_block(params, x, cfg)
            runs.append((out, aux, moe.moe_block.dropped))
    finally:
        moe.set_moe_opts()
        moe.moe_block.dropped = 0
    (o1, a1, d1), (o2, a2, d2) = runs
    assert torch.equal(o1, o2) and torch.equal(a1, a2) and int(d1) == int(d2) > 0


# ---- cells -------------------------------------------------------------------

def test_serve_shapes_wait_for_c6b_and_opts_are_checked():
    with pytest.raises(NotImplementedError, match="C6b"):
        dryrun.run_cell("gemma2-27b", "decode_32k", False)
    with pytest.raises(NotImplementedError, match="C6b"):
        dryrun.run_cell("xlstm-350m", "long_500k", True)   # sub-quadratic: it applies
    skip = dryrun.run_cell("gemma2-27b", "long_500k", False)
    assert skip["status"] == "skip" and "sub-quadratic" in skip["skip_reason"]
    with pytest.raises(ValueError, match="kv_gather"):
        dryrun.run_cell("gemma2-27b", "train_4k", False, opts={"kv_gather": True})


@pytest.mark.parametrize("multi_pod", [False, True])
def test_a_smoke_cell_runs_end_to_end(world, multi_pod, tmp_path):
    cfg = _smoke("mistral-nemo-12b", 1)
    res = dryrun.run_cell("mistral-nemo-12b", "train_4k", multi_pod, verbose=False, cfg=cfg)
    json.dumps(res)
    assert res["status"] == "ok" and res["n_devices"] == (512 if multi_pod else 256)
    assert res["n_micro"] == 8 and res["time_scan_undercount"] is False
    assert res["by_kernel"]["flash_attention"]["calls"] == 2 * cfg.n_layers * 8
    assert res["by_kernel"]["flash_attention_bwd"]["calls"] == cfg.n_layers * 8
    mem = res["memory"]
    assert 0 < mem["param_bytes_per_device_est"] < mem["peak_bytes_per_device"]
    roof = res["roofline"]
    assert roof["flops"] > 0 and roof["wire_bytes"] > 0 and roof["peak"] == "bf16"
    assert 0 < roof["useful_flops_ratio"] < 1
    assert res["collectives"]["data_all_reduce"]["calls"] >= 1
    assert 0 < res["once_wire"] < roof["wire_bytes"]
