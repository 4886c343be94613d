"""The port's logical-axis sharding rules (``repro_torch.parallel.sharding``)
against the reference's (``repro.parallel.sharding``).

First each case of ``tests/test_sharding.py`` on the port, on the same
stand-in meshes with the production sizes.  Then, for every architecture at
the meshes (16, 16), (2, 16, 16), (4, 2), (2, 4) and (1, 8): the rules
equal the reference's dict; the port's axes tree (``Model.init(...,
with_axes=True)``) equals the reference's smoke init's after
``interop.lm_axes_from_reference``'s layout change (its stacked layers one
dict a layer, their leading ``"layers"`` dropped); every parameter's spec
and ZeRO-1 spec equal the reference's ``PartitionSpec`` read as a tuple
(without its ``"layers"`` entry); every cache leaf's spec equals the
reference's without its groups entry.  The reference builds its
``NamedSharding`` on a real mesh; on the stand-ins the test reads the
spec it would wrap (``NamedSharding`` replaced by ``(mesh, spec) -> spec``
for the duration of the fixture).  Its trees come from ``jax.eval_shape``
of its smoke init and cache: no weights are drawn."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import functools

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.parallel import sharding as shd


class FakeMesh:
    """Stand-in with the production axis sizes (no real devices needed)."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


MESH1 = FakeMesh((16, 16), ("data", "model"))
MESH2 = FakeMesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"16x16": MESH1, "2x16x16": MESH2, "4x2": FakeMesh((4, 2), ("data", "model")),
          "2x4": FakeMesh((2, 4), ("data", "model")), "1x8": FakeMesh((1, 8), ("data", "model"))}
CACHE_BATCH, CACHE_LEN = 16, 32


# ---- tests/test_sharding.py on the port -----------------------------------

def test_heads_shard_when_divisible():
    rules = shd.make_rules(get_config("gemma2-27b"), MESH1)   # 32 heads % 16 == 0
    assert rules["heads"] == "model"
    assert rules["vocab"] == "model"     # 256000 % 16 == 0
    assert rules["embed"] is None


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "llava-next-34b",
                                  "whisper-large-v3", "recurrentgemma-2b"])
def test_embed_fallback_when_heads_dont_divide(arch):
    rules = shd.make_rules(get_config(arch), MESH1)
    assert rules["heads"] is None
    assert rules["embed"] == "model", f"{arch}: needs row-parallel fallback"


def test_moe_expert_parallel():
    rules = shd.make_rules(get_config("qwen3-moe-235b-a22b"), MESH1)
    assert rules["experts"] == "model"
    assert rules["ff"] == "data"         # 235B: FSDP of the expert ff dim over data
    rules2 = shd.make_rules(get_config("moonshot-v1-16b-a3b"), MESH1)
    assert rules2["experts"] == "model"
    assert rules2["ff"] == "model"       # small enough, no FSDP


def test_whisper_vocab_not_divisible_replicates():
    assert shd.make_rules(get_config("whisper-large-v3"), MESH1)["vocab"] is None  # 51866


def test_conflict_resolution_keeps_first():
    rules = {"vocab": "model", "embed": "model"}
    assert shd.spec_for_axes(("vocab", "embed"), rules) == ("model", None)
    assert shd.spec_for_axes(("embed", "vocab"), rules) == ("model", None)


def test_spec_for_axes_layers_never_sharded():
    rules = shd.make_rules(get_config("gemma2-27b"), MESH1)
    spec = shd.spec_for_axes(("layers", "embed", "heads", "head_dim"), rules)
    assert spec[0] is None and spec[2] == "model"


def test_batch_spec_divisibility():
    assert shd.batch_spec(MESH2, 256)[0] == ("pod", "data")  # 256 % 32 == 0
    assert shd.batch_spec(MESH2, 16)[0] == "data"            # only data fits
    assert shd.batch_spec(MESH2, 1)[0] is None               # long_500k b=1


def test_every_arch_has_some_model_sharding():
    """No arch may end up fully replicated on the production mesh."""
    for arch in ARCH_IDS:
        rules = shd.make_rules(get_config(arch), MESH1)
        assert any(v == "model" for v in rules.values()), (arch, rules)


def test_opt_state_zero1():
    """An attention weight (embed, heads, head_dim) with heads -> model: its
    parameter spec leaves embed whole, and ZeRO-1 puts 'data' there (4608
    % 16 == 0)."""
    rules = shd.make_rules(get_config("gemma2-27b"), MESH1)
    axes = ("embed", "heads", "head_dim")
    assert shd.spec_for_axes(axes, rules) == (None, "model", None)
    assert shd.zero1_spec(axes, (4608, 32, 128), rules, 16) == ("data", "model", None)


def test_data_mesh_over_local_devices():
    """data_mesh builds the 1-D 'data' mesh the MC engine shards over."""
    mesh = shd.data_mesh(["cpu"] * 4)
    assert mesh.axis_names == ("data",) and mesh.devices.shape == (4,)
    sub = shd.data_mesh(["cpu"])
    assert sub.devices.shape == (1,)
    assert shd.batch_spec(sub, 4, extra_dims=1) == ("data", None)


# ---- every arch, five meshes, against the reference ------------------------

@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's smoke axes tree, its params' and caches' shapes."""
    import jax

    from repro.configs import get_config as get_config_jax
    from repro.models import build_model as build_model_jax

    cfg = get_config_jax(arch, smoke=True)
    model = build_model_jax(cfg)
    box = {}

    def init(key):
        params, axes = model.init(key)
        box["axes"] = axes
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(CACHE_BATCH, CACHE_LEN))
    return cfg, box["axes"], shapes, cache


@pytest.fixture(scope="module")
def reference_specs():
    """The reference's sharding functions with ``NamedSharding`` reading
    back its spec (the stand-in meshes have no devices)."""
    from repro.parallel import sharding as shd_jax

    mp = pytest.MonkeyPatch()
    mp.setattr(shd_jax, "NamedSharding", lambda mesh, spec: spec)
    yield shd_jax
    mp.undo()


def _leaves_with_path(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, list):  # a tuple is a spec (or axes): a leaf
        return [x for i, v in enumerate(tree) for x in _leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def _port_axes(arch):
    cfg = get_config(arch, smoke=True)
    params, axes = build_model(cfg).init(None, with_axes=True)
    return cfg, params, axes


def _ref_layout(cfg, tree):
    """A reference tree with stacked layers in the port's per-layer layout
    (the same leaves repeated a layer; values untouched)."""
    if cfg.enc_dec:
        out = {k: v for k, v in tree.items() if k not in ("encoder", "decoder")}
        out["encoder"] = [tree["encoder"]] * cfg.n_enc_layers
        out["decoder"] = [tree["decoder"]] * cfg.n_layers
        return out
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [tree["blocks"][f"b{i % cfg.pattern_period}"] for i in range(cfg.n_layers)]
    return out


def _drop_first(spec):
    return tuple(spec)[1:]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_axes_and_specs_equal_the_reference(reference_specs, arch, mesh_name):
    shd_jax, mesh = reference_specs, MESHES[mesh_name]
    cfg_j, axes_j, shapes_j, _ = _reference(arch)
    cfg, params, axes = _port_axes(arch)
    rules = shd.make_rules(cfg, mesh)
    assert rules == shd_jax.make_rules(cfg_j, mesh)

    # the axes tree, in the port's layout
    assert axes == interop.lm_axes_from_reference(cfg, axes_j)

    # each leaf's spec and ZeRO-1 spec; stacked leaves without "layers"
    p_sh = _leaves_with_path(shd.param_shardings(mesh, axes, rules))
    o_sh = _leaves_with_path(shd.opt_state_shardings(
        mesh, axes, rules, _shape_tree(params)))
    pj = _ref_layout(cfg, shd_jax.param_shardings(mesh, axes_j, rules))
    oj = _ref_layout(cfg, shd_jax.opt_state_shardings(
        mesh, axes_j, rules, __import__("jax").tree.map(lambda x: x.shape, shapes_j)))
    stacked = set(("blocks", "encoder", "decoder"))
    want_p = [(path, _drop_first(s) if path[0] in stacked else tuple(s))
              for path, s in _leaves_with_path(pj, ())]
    want_o = [(path, _drop_first(s) if path[0] in stacked else tuple(s))
              for path, s in _leaves_with_path(oj, ())]
    assert p_sh == want_p
    # (where the reference's ZeRO-1 takes its stacked layers dimension, as
    # for phi4's norms at 2x4, the port has no such dimension to split)
    assert o_sh == want_o


def _shape_tree(params):
    if isinstance(params, dict):
        return {k: _shape_tree(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_shape_tree(v) for v in params]
    return tuple(params.shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference_without_groups(reference_specs, arch, mesh_name):
    shd_jax, mesh = reference_specs, MESHES[mesh_name]
    cfg_j, _, _, cache_j = _reference(arch)
    cfg = get_config(arch, smoke=True)
    rules = shd.make_rules(cfg, mesh)
    model = build_model(cfg)
    cache = model.init_cache(CACHE_BATCH, CACHE_LEN, torch.float32, device="meta")
    got_tree = shd.cache_shardings(mesh, cfg, cache, CACHE_BATCH, rules)
    want_tree = shd_jax.cache_shardings(mesh, cfg_j, cache_j, CACHE_BATCH, rules)
    if cfg.enc_dec:
        # the port projects cross_kv at prefill; the reference holds
        # (layers, B, Hkv, T_enc, hd) buffers from the start
        kv = {"k": torch.empty(CACHE_BATCH, cfg.n_kv_heads, cfg.enc_frames, cfg.head_dim_,
                               device="meta")}
        got_tree["cross_kv"] = [shd.cache_shardings(mesh, cfg, kv, CACHE_BATCH, rules)]
        want_tree = {"dec": [want_tree["dec"]] * cfg.n_layers,
                     "cross_kv": [{"k": want_tree["cross_kv"]["k"]}]}
    else:
        want_tree = [want_tree[f"b{i % cfg.pattern_period}"] for i in range(cfg.n_layers)]
    got = _leaves_with_path(got_tree)
    want = [(p, _drop_first(s)) for p, s in _leaves_with_path(want_tree)]
    # the port's ring flag is a Python bool where the reference has an array
    assert [(p, s) for p, s in got if p[-1] != "ring"] == [
        (p, s) for p, s in want if p[-1] != "ring"]


def test_placements_name_the_mesh_axes():
    """A spec entry 'model' is Shard(dim) on the mesh dimension named
    model, 'data' on the one named data; None and absent axes Replicate."""
    from torch.distributed.tensor import Replicate, Shard

    class Named:
        mesh_dim_names = ("data", "model")

    assert shd.placements_for(Named, (None, "model", None)) == [Replicate(), Shard(1)]
    assert shd.placements_for(Named, ("data", "model")) == [Shard(0), Shard(1)]
    assert shd.placements_for(Named, (("pod", "data"), None)) == [Shard(0), Replicate()]
    assert shd.placements_for(Named, ()) == [Replicate(), Replicate()]


def test_estimate_bytes_counts_global_shapes():
    tree = {"a": torch.empty(3, 4, device="meta"), "b": [torch.empty(5, dtype=torch.bfloat16,
                                                                      device="meta")], "s": 3}
    assert shd.estimate_bytes(tree) == 3 * 4 * 4 + 5 * 2
