"""Port parity for checkpointing (``repro_torch.checkpoint``): the cases of
``tests/test_checkpoint.py`` on the port's trees of tensors; the two
packages reading each other's checkpoints (zstd and zlib, a zlib leaf in
several pieces) with byte-equal indexes for one tree; the port's
MessagePack against ``msgpack``; a save that must not see the next step's
in-place update; ``tests/test_system.py``'s restart on the smoke
mistral-nemo from the reference's weights; and the reference's training
state carried into the port, whose next step's loss matches the
reference's within ``tests/test_torch_train.py``'s 1e-5."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import checkpoint as ck_jax
from repro.checkpoint import checkpoint as ckm_jax
from repro.configs import get_config as get_config_jax
from repro.models import build_model as build_model_jax
from repro.optim import adamw as adamw_jax
from repro.runtime.train_loop import make_train_step as make_train_step_jax
from repro_torch import checkpoint as ck
from repro_torch import interop
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import checkpoint as ckm
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import make_train_step

LOSS_RTOL = 1e-5  # tests/test_torch_train.py's


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "layer": {"w": torch.randn((8, 16), generator=g),
                  "b": torch.zeros(16, dtype=torch.bfloat16)},
        "emb": torch.randn((32, 8), generator=g),
    }


def _meta(tree):
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if not isinstance(x, torch.Tensor):  # AdamW's step
            assert type(x) is type(y) and x == y
            continue
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


def _zlib_only(monkeypatch, *modules):
    for m in modules:
        monkeypatch.setattr(m, "zstandard", None)
        monkeypatch.setattr(m, "DEFAULT_CODEC", "zlib")


# ---------------------------------------------- tests/test_checkpoint.py


def test_save_restore_roundtrip(tmp_path):
    t = _tree(0)
    t["layer"]["b"] += 1.5
    ck.save(tmp_path, 5, t, metadata={"step": 5})
    r, meta = ck.restore(tmp_path, 5, _meta(t))
    assert meta["step"] == 5
    _equal(t, r)
    assert all(x.device.type == "cpu" for x in tree_leaves(r))


def test_restore_latest_and_gc(tmp_path):
    t = _tree(1)
    for s in (1, 2, 3, 4):
        ck.save(tmp_path, s, t, keep_last=2)
    assert ck.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_000000003", "step_000000004"
    ]


def test_optimizer_state_roundtrip(tmp_path):
    params = _tree(2)
    tree = {"params": params, "opt": adamw.init(params)}
    ck.save(tmp_path, 1, tree)
    target = {"params": _meta(params), "opt": adamw.AdamWState(
        0, _meta(tree["opt"].m), _meta(tree["opt"].v))}
    r, _ = ck.restore(tmp_path, 1, target)
    assert isinstance(r["opt"], adamw.AdamWState) and r["opt"].step == 0
    assert type(r["opt"].step) is int
    _equal(r["params"], params)
    _equal(r["opt"].m, tree["opt"].m)


def test_async_checkpointer(tmp_path):
    t = _tree(3)
    acp = ck.AsyncCheckpointer(tmp_path)
    acp.save_async(7, t, metadata={"step": 7})
    acp.wait()
    assert ck.latest_step(tmp_path) == 7
    assert acp.snapshot_s >= 0 and acp.write_s > 0


def test_shape_mismatch_raises(tmp_path):
    t = _tree(4)
    ck.save(tmp_path, 1, t)
    bad = tree_map(lambda x: torch.empty((1,) + tuple(x.shape), dtype=x.dtype, device="meta"), t)
    with pytest.raises(ValueError):
        ck.restore(tmp_path, 1, bad)


def test_zlib_roundtrip_with_zstd_missing(tmp_path, monkeypatch):
    """A zlib-only build (no zstandard) round-trips its own checkpoints:
    zlib-written leaf files, the codec recorded in the index."""
    _zlib_only(monkeypatch, ckm)
    t = _tree(6)
    ck.save(tmp_path, 1, t)
    assert list(tmp_path.glob("step_*/*.zz")), "zlib leaves carry .zz"
    r, _ = ck.restore(tmp_path, 1, _meta(t))
    _equal(t, r)


def test_zstd_checkpoint_without_wheel_raises_actionable_error(tmp_path, monkeypatch):
    """A zstd-written checkpoint read in a zlib-only environment fails with
    one error naming the missing codec."""
    class _FakeCompressor:
        def __init__(self, level=3):
            pass

        def compress(self, data):
            return bytes(data)  # restore must fail before decoding a leaf

    monkeypatch.setattr(ckm, "zstandard", types.SimpleNamespace(ZstdCompressor=_FakeCompressor))
    monkeypatch.setattr(ckm, "DEFAULT_CODEC", "zstd")
    t = _tree(7)
    ck.save(tmp_path, 1, t)
    assert list(tmp_path.glob("step_*/*.zst")), "zstd leaves carry .zst"
    monkeypatch.setattr(ckm, "zstandard", None)  # the zlib-only environment
    with pytest.raises(RuntimeError, match="zstandard"):
        ck.restore(tmp_path, 1, _meta(t))


def test_corrupt_leaf_error_names_codec(tmp_path, monkeypatch):
    """A leaf that fails to decode reports the leaf, file and codec."""
    _zlib_only(monkeypatch, ckm)
    t = _tree(8)
    ck.save(tmp_path, 1, t)
    leaf = sorted(tmp_path.glob("step_*/*.zz"))[0]
    leaf.write_bytes(b"\x00not-zlib-data")
    with pytest.raises(RuntimeError, match="zlib"):
        ck.restore(tmp_path, 1, _meta(t))


def test_restore_with_device_placement(tmp_path):
    """The single-card form of reshard-on-restore: one device for every
    leaf, or a tree of them; a real target of the same shape, type and
    device is restored into; a sharded placement waits for the multi-card
    slice."""
    from torch.distributed.tensor import Replicate

    t = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones(3, dtype=torch.bfloat16)}
    ck.save(tmp_path, 1, t)
    r, _ = ck.restore(tmp_path, 1, _meta(t), device="cpu")
    _equal(t, r)
    r, _ = ck.restore(tmp_path, 1, _meta(t), device={"w": torch.device("cpu"), "b": None})
    _equal(t, r)
    live = {"w": torch.zeros(4, 4), "b": torch.zeros(3, dtype=torch.bfloat16)}
    r, _ = ck.restore(tmp_path, 1, live)
    assert r["w"] is live["w"] and r["b"] is live["b"]
    _equal(t, live)
    other = {"w": torch.zeros(4, 4, dtype=torch.float64), "b": live["b"]}
    r, _ = ck.restore(tmp_path, 1, other)
    assert r["w"] is not other["w"] and r["w"].dtype == torch.float32
    with pytest.raises(TypeError, match="DeviceMesh, placements"):
        ck.restore(tmp_path, 1, _meta(t), device={"w": Replicate(), "b": None})
    # a (DeviceMesh, placements) pair gives a DTensor of this rank's chunk:
    # here one rank of a 1 x 1 mesh (tests/test_torch_tp.py restores across
    # meshes of several ranks)
    import torch.distributed as dist

    from repro_torch.launch import mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        m11 = mesh.make_device_mesh(1, 1)
        r, _ = ck.restore(tmp_path, 1, _meta(t), device={"w": (m11, [Replicate(), Replicate()]),
                                                          "b": None})
        assert type(r["w"]).__name__ == "DTensor" and torch.equal(r["w"].to_local(), t["w"])
        _equal({"b": t["b"]}, {"b": r["b"]})
    finally:
        dist.destroy_process_group()


def test_save_async_copies_before_the_next_in_place_step(tmp_path):
    """adamw.apply updates parameters and moments in place: save_async must
    have its own host copy when it returns, as the reference's np.asarray."""
    params = _tree(9)
    state = adamw.init(params)
    before = tree_map(lambda x: x.clone(), {"params": params, "m": state.m})
    acp = ck.AsyncCheckpointer(tmp_path)
    acp.save_async(1, {"params": params, "opt": state})
    grads = tree_map(lambda x: torch.ones_like(x, dtype=torch.float32).to(x.dtype), params)
    adamw.apply(adamw.AdamWConfig(lr=0.5, warmup_steps=0), params, grads, state)
    acp.wait()
    assert not torch.equal(params["emb"], before["params"]["emb"])
    r, _ = ck.restore(tmp_path, 1, {"params": _meta(params), "opt": adamw.AdamWState(
        0, _meta(state.m), _meta(state.v))})
    _equal(r["params"], before["params"])
    _equal(r["opt"].m, before["m"])


# ------------------------------------------ the two packages' checkpoints


def _both_trees(seed=0):
    """One tree (a bf16 leaf among float32 ones, and AdamW's state) in the
    reference's form (jax arrays) and the port's (tensors)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"layer": {"w": jax.random.normal(k1, (8, 16)),
                        "b": (jnp.arange(16) / 7).astype(jnp.bfloat16)},
              "emb": jax.random.normal(k2, (32, 8))}
    ref = {"params": params, "opt": adamw_jax.init(params)}
    ref["opt"] = ref["opt"]._replace(step=jnp.asarray(3, jnp.int32))

    def to_torch(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    p = jax.tree.map(to_torch, params)
    port = {"params": p, "opt": adamw.AdamWState(
        3, jax.tree.map(to_torch, ref["opt"].m), jax.tree.map(to_torch, ref["opt"].v))}
    return ref, port


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(params=["zstd", "zlib", "zlib-pieces"])
def codec(request, monkeypatch):
    if request.param != "zstd":
        _zlib_only(monkeypatch, ckm, ckm_jax)
    if request.param == "zlib-pieces":
        monkeypatch.setattr(ckm, "CHUNK_BYTES", 100)  # every larger leaf in pieces
    return request.param


def test_indexes_equal_and_each_package_reads_the_others(tmp_path, codec):
    ref, port = _both_trees()
    ck_jax.save(tmp_path / "ref", 3, ref, metadata={"step": 3})
    ck.save(tmp_path / "port", 3, port, metadata={"step": 3})
    idx_ref = (tmp_path / "ref" / "step_000000003" / "index.msgpack").read_bytes()
    idx_port = (tmp_path / "port" / "step_000000003" / "index.msgpack").read_bytes()
    assert idx_port == idx_ref
    assert msgpack.unpackb(idx_port)["codec"] == codec.split("-")[0]
    # the port reads the reference's
    target = {"params": _meta(port["params"]), "opt": adamw.AdamWState(
        0, _meta(port["opt"].m), _meta(port["opt"].v))}
    r, meta = ck.restore(tmp_path / "ref", None, target)
    assert meta == {"step": 3} and r["opt"].step == 3
    _equal(r, port)
    # the reference reads the port's
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ref)
    r_ref, meta = ck_jax.restore(tmp_path / "port", None, shapes)
    assert meta == {"step": 3} and int(r_ref["opt"].step) == 3
    for a, b in zip(_ref_leaves(ref), _ref_leaves(r_ref)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_numpy_target_gets_numpy_leaves(tmp_path):
    """A target of numpy arrays (a reference-shaped tree) comes back as
    numpy arrays, bf16 in the target's own type."""
    ref, port = _both_trees(1)
    ck_jax.save(tmp_path, 2, ref)
    target = jax.tree.map(np.asarray, ref)
    r, _ = ck.restore(tmp_path, 2, target)
    for a, b in zip(jax.tree.leaves(target), jax.tree.leaves(r)):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)


def _index_like(draw):
    ints = st.one_of(st.integers(-2 ** 63, 2 ** 64 - 1), st.integers(-40, 300),
                     st.sampled_from([0, 127, 128, 255, 256, 65535, 65536, -32, -33, -128, -129,
                                      -32768, -32769, 2 ** 32 - 1, 2 ** 32, -2 ** 31,
                                      -2 ** 31 - 1]))
    scalars = [ints, st.floats(allow_nan=False), st.booleans(), st.none(), st.text(max_size=40),
               st.binary(max_size=300)]

    def value(depth):
        kind = draw(st.integers(0, len(scalars) + (1 if depth < 3 else -1)))
        if kind < len(scalars):
            return draw(scalars[kind])
        n = draw(st.sampled_from([0, 1, 3, 15, 16, 17]))
        if kind == len(scalars):
            return [value(depth + 1) for _ in range(n)]
        return {draw(st.text(max_size=20)): value(depth + 1) for _ in range(n)}

    return {"leaves": {draw(st.text(min_size=1, max_size=70)): {
                "shape": [draw(st.integers(0, 2 ** 20)) for _ in range(draw(st.integers(0, 4)))],
                "dtype": draw(st.sampled_from(["float32", "bfloat16", "int32"])),
                "file": draw(st.text(max_size=80)) + ".zz",
                "raw_bytes": draw(st.integers(0, 2 ** 40))}
                       for _ in range(draw(st.integers(0, 20)))},
            "step": draw(st.integers(0, 2 ** 31)), "codec": draw(st.sampled_from(["zlib", "zstd"])),
            "metadata": value(0)}


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_msgpack_pack_equals_msgpack_and_unpack_inverts(data):
    obj = _index_like(data.draw)
    packed = _msgpack.pack(obj)
    assert packed == msgpack.packb(obj)
    assert _msgpack.unpack(packed) == msgpack.unpackb(packed, raw=False) == obj


def test_msgpack_long_strings_and_containers():
    for obj in ("x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 70000, b"y" * 256, b"y" * 70000,
                list(range(70000)), {str(i): i for i in range(70000)}, 1.5, -0.0,
                float("inf")):
        assert _msgpack.pack(obj) == msgpack.packb(obj)
        assert _msgpack.unpack(msgpack.packb(obj)) == msgpack.unpackb(msgpack.packb(obj))
    with pytest.raises(OverflowError):
        _msgpack.pack(2 ** 64)
    with pytest.raises(TypeError):
        _msgpack.pack(object())


# ------------------------------------------------------- restart and resume


@pytest.fixture(scope="module")
def trained():
    """tests/test_system.py's run on the port: the smoke mistral-nemo from
    the reference's weights, 40 steps of the synthetic stream."""
    cfg_jax = get_config_jax("mistral-nemo-12b", smoke=True)
    params_jax, _ = build_model_jax(cfg_jax).init(jax.random.PRNGKey(0))
    cfg = get_config("mistral-nemo-12b", smoke=True)
    model = build_model(cfg)
    params = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params_jax), "cpu")
    opt_cfg = adamw.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=60, weight_decay=0.01)
    data = SyntheticLM(cfg.vocab, seq_len=32, global_batch=8, n_micro=2, seed=0)
    step = make_train_step(model, opt_cfg, 2, pre_shaped=True, device="cpu")
    opt_state = adamw.init(params)
    losses = []
    for s in range(40):
        params, opt_state, m = step(params, opt_state, data.batch(s))
        losses.append(float(m["loss"]))
    return cfg, model, params, opt_state, losses, data, step


def test_checkpoint_restart_continues_loss_curve(trained, tmp_path):
    cfg, model, params, opt_state, losses, data, step = trained
    ck.save(tmp_path, 40, {"params": params, "opt": opt_state})
    target = {"params": _meta(params), "opt": adamw.AdamWState(
        0, _meta(opt_state.m), _meta(opt_state.v))}
    restored, _ = ck.restore(tmp_path, 40, target)
    assert restored["opt"].step == 40
    p2, o2 = restored["params"], restored["opt"]
    cont = []
    for s in range(40, 45):
        p2, o2, m = step(p2, o2, data.batch(s))
        cont.append(float(m["loss"]))
    assert all(np.isfinite(cont))
    assert np.mean(cont) < np.mean(losses[:5]), "restart lost progress"
    # bit-exact state round trip: one more step from the live state matches
    live = tree_map(lambda x: x.clone(), {"params": params, "opt_m": opt_state.m,
                                          "opt_v": opt_state.v})
    _, _, m_live = step(live["params"], adamw.AdamWState(opt_state.step, live["opt_m"],
                                                         live["opt_v"]), data.batch(40))
    assert cont[0] == float(m_live["loss"])


def test_reference_training_state_resumes_in_the_port(tmp_path):
    """The reference trains 3 steps and saves; the port restores that
    checkpoint into a numpy target, carries it across with ``interop``, and
    its step 4 matches the reference's (loss within 1e-5)."""
    cfg_jax = get_config_jax("mistral-nemo-12b", smoke=True)
    model_jax = build_model_jax(cfg_jax)
    params, _ = model_jax.init(jax.random.PRNGKey(1))
    opt = dict(lr=5e-3, warmup_steps=1, total_steps=10, weight_decay=0.01)
    step_jax = jax.jit(make_train_step_jax(model_jax, adamw_jax.AdamWConfig(**opt), 2,
                                           pre_shaped=True))
    rng = np.random.default_rng(3)
    batches = [{k: rng.integers(0, cfg_jax.vocab, size=(2, 4, 16)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(4)]
    state = adamw_jax.init(params)
    for b in batches[:3]:
        params, state, _ = step_jax(params, state, jax.tree.map(jnp.asarray, b))
    ck_jax.save(tmp_path, 3, {"params": params, "opt": state}, metadata={"step": 3})
    _, _, m_ref = step_jax(params, state, jax.tree.map(jnp.asarray, batches[3]))

    target = jax.tree.map(np.asarray, {"params": params, "opt": state})
    tree, meta = ck.restore(tmp_path, None, target)
    assert meta["step"] == 3 and isinstance(tree["params"]["embed"], np.ndarray)
    cfg = get_config("mistral-nemo-12b", smoke=True)
    p = interop.lm_params_from_numpy(cfg, tree["params"], "cpu")
    s = interop.adamw_state_from_numpy(tree["opt"], cfg, "cpu")
    assert s.step == 3
    step = make_train_step(build_model(cfg), adamw.AdamWConfig(**opt), 2, pre_shaped=True,
                           device="cpu")
    _, s2, m = step(p, s, batches[3])
    assert s2.step == 4
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(m_ref["grad_norm"]), rtol=1e-4)
