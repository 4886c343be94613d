"""The tensor-parallel LM across ``torch.distributed`` ranks on the CPU
(gloo; slice C5b): the train step on a ``(data, model)`` ``DeviceMesh``,
ZeRO-1 AdamW, checkpoints of a sharded state, and ``launch/train --mesh
D,M``.

One set of 8 ranks is spawned for the whole file (``launch.mesh.spawn_ranks``);
every case runs in it.  ``DeviceMesh`` creation is collective over the
world, so every rank creates every mesh, those a case leaves out too.

* The (4, 2) step is ``tests/test_multidevice.py``'s part 1: gemma2-27b
  smoke, 2 microbatches of 4 x 16 tokens, AdamW at a constant 1e-3 without
  decay, held to the reference's single-device jitted ``make_train_step``
  (parameters within 2e-4, loss within 1e-4: that test's own bounds; the
  reference's sharded step itself raises under JAX 0.9, see ROADMAP.md).
  The same for phi4-mini smoke at (2, 4) (6 heads: the embed fallback,
  attention computed alike on the model axis) and granite-20b smoke at
  (4, 2) (its q heads split, its single kv head whole).  Each is also held
  to the port's one-process step at the training anchors (the loss within
  1e-5 relative, each gradient leaf within 1e-4 of its max |g|), and each
  rank's m and v placements equal ``opt_state_shardings``'.
* A checkpoint saved from a (2, 2) mesh comes back bitwise on a (1, 2)
  mesh and in one process, and its index is byte-equal with a one-process
  save of the same values.
* ``launch/train --mesh 2,2`` on 4 ranks, with and without ``--coded-dp``:
  the loss history of the one-process run (the data-parallel run of the
  same global batch; the coded workers run in turn) within 1e-5 relative.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import os

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.launch import mesh
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.parallel import tensor as tp
from repro_torch.runtime.train_loop import make_train_step

WORLD = 8
CASES = {"gemma2": ("gemma2-27b", (4, 2)), "phi4": ("phi4-mini-3.8b", (2, 4)),
         "granite": ("granite-20b", (4, 2))}
OPT = dict(lr=1e-3, warmup_steps=0, schedule="constant", weight_decay=0.0)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
SMOKE = ["--arch", "mistral-nemo-12b", "--smoke", "--device", "cpu", "--seq", "16",
         "--batch", "4", "--steps", "2", "--log-every", "1"]


def _tokens(arch: str) -> np.ndarray:
    """tests/test_multidevice.py's batch shape: 2 microbatches of 4 x 16."""
    return np.random.default_rng(1).integers(0, get_config(arch, smoke=True).vocab,
                                             size=(2, 4, 16)).astype(np.int32)


def _batch(tok):
    tok = torch.as_tensor(tok)
    return {"tokens": tok, "labels": tok}


def _port(arch: str, init):
    model = build_model(get_config(arch, smoke=True))
    return model, interop.lm_params_from_numpy(model.cfg, init, "cpu")


def _placed(model, params, dmesh):
    """``params`` laid out on ``dmesh`` by the rules, ZeRO-1 moments, and
    the moments' shardings."""
    _, axes = model.init(None, with_axes=True)
    rules = sharding.make_rules(model.cfg, dmesh)
    p = tp.place_tree(params, sharding.param_shardings(dmesh, axes, rules))
    o_sh = sharding.opt_state_shardings(dmesh, axes, rules, params)
    return p, adamw.init(p, o_sh), o_sh


def _shapes_seen(fn):
    """Wrap the plain attention to record each call's (Hq, Hkv)."""
    from repro_torch.kernels.flash_attention import ops

    seen, plain = [], ops.attention_ref

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1]))
        return plain(q, k, v, **kw)

    ops.attention_ref = spy
    try:
        return fn(), seen
    finally:
        ops.attention_ref = plain


def _step_case(rank, dmesh, arch, init):
    model, params = _port(arch, init)
    p, o, o_sh = _placed(model, params, dmesh)
    step = make_train_step(model, adamw.AdamWConfig(**OPT), 2, pre_shaped=True, device="cpu",
                           mesh=dmesh)
    batch = _batch(_tokens(arch))
    tp.reset_counts()
    (grads, g_loss), heads = _shapes_seen(lambda: step.grads(p, batch))
    grads = tp.gather_tree(grads)
    p, o, m = step(p, o, batch)
    placements_ok = all(tree_leaves(tree_map(
        lambda x, s: list(x.placements) == list(s[1]), moments,
        tp.shardings_like(o_sh, moments)))
        for moments in (o.m, o.v))
    full = tp.gather_tree(p)
    out = dict(loss=float(m["loss"]), g_loss=float(g_loss), step=o.step,
               placements_ok=placements_ok, heads=sorted(set(heads)), counts=tp.counts())
    if rank == 0:
        out.update(params=full, grads=grads)
    return out


def _ckpt_case(rank, root, init):
    """Save from (2, 2) on ranks 0-3; restore onto (1, 2) on ranks 0-1."""
    import torch.distributed as dist

    model, params = _port("gemma2-27b", init)
    out = {}
    m22 = mesh.make_device_mesh(2, 2)
    if m22.get_coordinate() is not None:
        p, o, _ = _placed(model, params, m22)
        step = make_train_step(model, adamw.AdamWConfig(**OPT), 2, pre_shaped=True,
                               device="cpu", mesh=m22)
        p, o, _ = step(p, o, _batch(_tokens("gemma2-27b")))
        state = {"params": p, "opt": o}
        written = ck.save(os.path.join(root, "mesh"), 1, state, metadata={"step": 1})
        saved = tp.gather_tree(state)
        if rank == 0:
            ck.save(os.path.join(root, "one"), 1, saved, metadata={"step": 1})
            out["saved"] = saved
        out["wrote"] = written is not None
    dist.barrier()
    m12 = mesh.make_device_mesh(1, 2)
    if m12.get_coordinate() is not None:
        p, o, o_sh = _placed(model, tree_map(torch.zeros_like, params), m12)
        got, meta = ck.restore(os.path.join(root, "mesh"), None, {"params": p, "opt": o})
        out["restored"] = tp.gather_tree(got)
        out["in_place"] = all(a is b for a, b in zip(tree_leaves(got["params"]),
                                                     tree_leaves(p)))
        # the counterpart of the reference's shardings: (mesh, placements) a leaf
        _, axes = model.init(None, with_axes=True)
        pairs = sharding.param_shardings(m12, axes, sharding.make_rules(model.cfg, m12))
        meta_params = tree_map(lambda x: torch.empty(x.shape, device="meta"), params)
        got2, _ = ck.restore(os.path.join(root, "mesh"), None, {"params": meta_params},
                             device={"params": pairs})
        out["restored_pairs"] = tp.gather_tree(got2)["params"]
        out["meta"] = meta
    return out


WHOLE_ARCHS = ("whisper-large-v3", "recurrentgemma-2b", "xlstm-350m")


def _batch_for(cfg):
    """2 x 8 tokens (and whisper's stub frames) from numpy draws."""
    rng = np.random.default_rng(3)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int64))
    b = {"tokens": tok, "labels": tok}
    if cfg.enc_dec:
        b["embeds"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.enc_frames, cfg.d_model)).astype(np.float32) * 0.02)
    return b


def _whole_case(dmesh, arch):
    """Loss and gradients of a family whose mixers gather their weights
    whole on the model axis, its weights laid out by the rules."""
    model = build_model(get_config(arch, smoke=True))
    params, axes = model.init(0, device="cpu", with_axes=True)
    rules = sharding.make_rules(model.cfg, dmesh)
    p = tp.place_tree(params, sharding.param_shardings(dmesh, axes, rules))
    step = make_train_step(model, adamw.AdamWConfig(**OPT), 1, device="cpu", mesh=dmesh)
    grads, loss = step.grads(p, _batch_for(model.cfg))
    return dict(loss=float(loss), grads=tp.gather_tree(grads))


def rank_cases(rank: int, world: int, store: str, inits: dict, ckpt_root: str) -> dict:
    import torch.distributed as dist

    group = mesh.init_ranks(rank, world, device="cpu", store_path=store, timeout_s=180)
    out = {}
    meshes = {shape: mesh.make_device_mesh(*shape) for shape in ((4, 2), (2, 4))}
    for name, (arch, shape) in CASES.items():
        out[name] = _step_case(rank, meshes[shape], arch, inits[name])
    out["ckpt"] = _ckpt_case(rank, ckpt_root, inits["gemma2"])
    for arch in WHOLE_ARCHS:
        got = _whole_case(meshes[(4, 2)], arch)
        out[arch] = got if rank == 0 else dict(loss=got["loss"])

    # launch/train --mesh 2,2 on ranks 0-3 (plain, then --coded-dp); ranks
    # 4-7 join the creation of the two meshes the runs build
    first4 = dist.new_group([0, 1, 2, 3])
    for coded in ([], ["--coded-dp"]):
        if rank < 4:
            res = train_launch.run(SMOKE + ["--mesh", "2,2"] + coded, group=first4)
            out["launch" + ("_coded" if coded else "")] = dict(
                losses=[h["loss"] for h in res["history"]], ranks=res["ranks"],
                e_beta=res["sched_e_beta"])
        else:
            mesh.make_device_mesh(2, 2)
    dist.destroy_process_group()
    del group
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device side on the same numpy tokens: each
    case's init, its jitted step's parameters and loss.  JAX is imported
    here only: the spawned ranks import this module."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_config_jax
    from repro.models import build_model as build_model_jax
    from repro.optim import adamw as adamw_jax
    from repro.runtime.train_loop import make_train_step as make_train_step_jax

    out = {}
    for name, (arch, _) in CASES.items():
        model = build_model_jax(get_config_jax(arch, smoke=True))
        params, _ = model.init(jax.random.PRNGKey(0))
        tok = jnp.asarray(_tokens(arch))
        step = jax.jit(make_train_step_jax(model, adamw_jax.AdamWConfig(**OPT), 2,
                                           pre_shaped=True))
        p1, _, m1 = step(params, adamw_jax.init(params), {"tokens": tok, "labels": tok})
        out[name] = dict(init=jax.tree.map(np.asarray, params),
                         params=jax.tree.map(np.asarray, p1), loss=float(m1["loss"]))
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp-ckpt"))
    outs = mesh.spawn_ranks(rank_cases, WORLD, {k: v["init"] for k, v in reference.items()},
                            root, timeout_s=400)
    return outs, root


def _bitwise(a, b) -> bool:
    """Every leaf of a equal to b's of the same key (ints by value)."""
    return all(tree_leaves(tree_map(
        lambda x, y: torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, a, b)))


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_the_reference_and_the_one_process_step(reference, ranks, case):
    outs, _ = ranks
    arch, shape = CASES[case]
    model, params = _port(arch, reference[case]["init"])
    want = interop.lm_params_from_numpy(model.cfg, reference[case]["params"], "cpu")
    step = make_train_step(model, adamw.AdamWConfig(**OPT), 2, pre_shaped=True, device="cpu")
    g1, l1 = step.grads(params, _batch(_tokens(arch)))
    p1, _, m1 = step(tree_map(lambda x: x.clone(), params), adamw.init(params),
                     _batch(_tokens(arch)))
    got = outs[0][case]
    assert got["step"] == 1
    assert abs(got["loss"] - reference[case]["loss"]) < 1e-4
    assert _max_err(want, got["params"]) < 2e-4
    # the port's one-process step at the training anchors
    assert abs(got["g_loss"] - float(l1)) <= LOSS_RTOL * abs(float(l1))
    for a, b in zip(tree_leaves(got["grads"]), tree_leaves(g1)):
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max()), case
    assert _max_err(p1, got["params"]) < 2e-4
    for out in outs:  # every rank reports the same loss and its ZeRO-1 layout
        assert out[case]["loss"] == got["loss"] and out[case]["placements_ok"]


def test_heads_each_rank_attends_over(ranks):
    """K4's local call (here its plain version) sees the rank's heads:
    gemma2 smoke's 4/2 heads split 2/1 at M 2; phi4 smoke's 6/2 heads stay
    whole at M 4 (the embed fallback); granite smoke's 4 q heads split 2 a
    rank, each reading the one kv head."""
    outs, _ = ranks
    cfgs = {c: get_config(CASES[c][0], smoke=True) for c in CASES}
    for out in outs:
        g, p, gr = cfgs["gemma2"], cfgs["phi4"], cfgs["granite"]
        assert out["gemma2"]["heads"] == [(g.n_heads // 2, g.n_kv_heads // 2)]
        assert out["phi4"]["heads"] == [(p.n_heads, p.n_kv_heads)]
        assert out["granite"]["heads"] == [(gr.n_heads // 2, 1)] and gr.n_kv_heads == 1


def test_no_step_gathers_the_table_or_the_logits(ranks):
    """The collectives of a step by kind: the vocab-split table and logits
    are never gathered (no tp_gather where the rules split heads and
    vocab), and what the loss sends is a few values a token."""
    outs, _ = ranks
    for out in outs:
        counts = out["gemma2"]["counts"]
        assert "tp_gather" not in counts, counts
        ce_calls, ce_bytes = counts["ce_all_reduce"]
        assert ce_calls == 3 * 2 * 2 and ce_bytes <= ce_calls * 4 * 64  # fwd of grads + step
    # the embed fallback gathers its weights whole, never the logits
    phi = outs[0]["phi4"]["counts"]
    assert phi["tp_gather"][0] > 0 and "ce_all_reduce" in phi


def test_checkpoint_from_a_2x2_mesh_restores_on_1x2_and_one_process(ranks):
    outs, root = ranks
    assert [o["ckpt"].get("wrote") for o in outs[:4]] == [True, False, False, False]
    saved = outs[0]["ckpt"]["saved"]
    for out in outs[:2]:
        got = out["ckpt"]
        assert got["meta"] == {"step": 1} and got["in_place"]
        assert _bitwise(got["restored"], saved)
        assert _bitwise(got["restored_pairs"], saved["params"])
    target = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
                      if isinstance(x, torch.Tensor) else x, saved)
    one, meta = ck.restore(os.path.join(root, "mesh"), None, target)
    assert meta == {"step": 1} and _bitwise(one, saved)
    idx = "step_000000001/index.msgpack"
    with open(os.path.join(root, "mesh", idx), "rb") as a, \
            open(os.path.join(root, "one", idx), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("arch", WHOLE_ARCHS)
def test_families_that_gather_their_weights_match_the_one_process_step(ranks, arch):
    """whisper's encoder-decoder and the recurrent mixers run on a (4, 2)
    mesh with their weights gathered whole on the model axis: the loss and
    each gradient leaf the one-process step's at the training anchors
    (the whole batch on every data rank: 2 rows do not split over 4)."""
    outs, _ = ranks
    model = build_model(get_config(arch, smoke=True))
    params = model.init(0, device="cpu")
    g1, l1 = make_train_step(model, adamw.AdamWConfig(**OPT), 1, device="cpu").grads(
        params, _batch_for(model.cfg))
    got = outs[0][arch]
    assert abs(got["loss"] - float(l1)) <= LOSS_RTOL * abs(float(l1))
    for a, b in zip(tree_leaves(got["grads"]), tree_leaves(g1)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= GRAD_TOL * scale or scale < 1e-6 * max(
            float(x.abs().max()) for x in tree_leaves(g1)), arch
    assert all(out[arch]["loss"] == got["loss"] for out in outs)


@pytest.mark.parametrize("coded", [False, True])
def test_launch_train_mesh_2_2_on_four_ranks(ranks, coded):
    outs, _ = ranks
    key = "launch_coded" if coded else "launch"
    ref = train_launch.run(SMOKE + (["--mesh", "2,1", "--coded-dp"] if coded else []))
    want = [h["loss"] for h in ref["history"]]
    for out in outs[:4]:
        got = out[key]
        assert got["ranks"] == 4 and got["e_beta"].shape == (2,)
        assert np.allclose(got["losses"], want, rtol=LOSS_RTOL, atol=0), (got["losses"], want)
