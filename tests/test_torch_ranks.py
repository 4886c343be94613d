"""The port's paths with a collective, across ``torch.distributed`` ranks on
the CPU (gloo; slice C5a): ``parallel.collectives`` (``coded_psum``,
``sharded_cross_entropy``), the data-parallel train step on 4 ranks, the
coded data-parallel step on 8 ranks, and ``launch/train --mesh 2,1``
(with and without ``--coded-dp``) on 2 ranks; and the backend a rank's
process group takes.

One set of 8 ranks is spawned for the whole file (``launch.mesh.spawn_ranks``,
a FileStore rendezvous, one torch thread a rank); every case runs in it and
returns its results.  The train steps start from the reference's init,
carried into the ranks through ``interop``, and are held to the
reference's single-device functions on the same numpy tokens: its jitted
``make_train_step`` for the DP step, and for the coded step the uncoded
data-parallel update (``jax.grad`` per worker, summed, AdamW) that
``tests/test_coded_train_step.py`` holds its own coded step to.  Beside
that, each is held to the port's one-process step.  Bounds:
``tests/test_multidevice.py``'s (the DP step's parameters within 2e-4 and
its loss within 1e-4; the sharded cross-entropy within 1e-5 of the dense
one), ``tests/test_coded_train_step.py``'s (the coded update within 5e-5),
and ``tests/test_torch_train.py``'s (a loss within 1e-5 relative, a
gradient leaf within 1e-4 of its max |g|)."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import mesh
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, cross_entropy
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import make_coded_train_step, make_train_step

WORLD = 8
DP_RANKS = 4
DP_ARCH, CODED_ARCH = "gemma2-27b", "mistral-nemo-12b"
SMOKE = ["--arch", "mistral-nemo-12b", "--smoke", "--device", "cpu", "--seq", "16",
         "--batch", "4", "--steps", "2", "--log-every", "1"]
OPT = dict(lr=1e-3, warmup_steps=0, schedule="constant", weight_decay=0.0)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _psum_tree(r: int):
    g = torch.Generator().manual_seed(100 + r)
    return {"a": torch.randn(5, generator=g), "b": [torch.randn(2, 3, generator=g)]}


def _ce_inputs():
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(2, 8, 64, generator=g)
    return logits, torch.randint(0, 64, (2, 8), generator=g)


def _tokens(arch: str, shape) -> np.ndarray:
    return np.random.default_rng(1).integers(0, get_config(arch, smoke=True).vocab,
                                             size=shape).astype(np.int32)


def _dp_tokens():
    """tests/test_multidevice.py's step: gemma2-27b smoke, 2 microbatches of
    4 x 16 tokens, AdamW at a constant 1e-3 without decay."""
    return _tokens(DP_ARCH, (2, 4, 16))


def _coded_tokens():
    """tests/test_coded_train_step.py's setup: mistral-nemo-12b smoke, R=8
    workers, 4 parities, microbatches of 2 x 16 tokens."""
    return _tokens(CODED_ARCH, (WORLD, 2, 16))


def _port(arch: str, init):
    """The port's model and its parameters from the reference's init."""
    model = build_model(get_config(arch, smoke=True))
    return model, interop.lm_params_from_numpy(model.cfg, init, "cpu")


def _batch(tok):
    tok = torch.as_tensor(tok)
    return {"tokens": tok, "labels": tok}


def _one_straggler(code, pats, ws):
    """The table's first pattern that drops exactly one worker's own result."""
    for pat, w in zip(pats[1:], ws[1:]):
        if len(np.flatnonzero(~pat[:code.R])) == 1:
            return w
    raise AssertionError("no one-straggler pattern in the table")


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def rank_cases(rank: int, world: int, store: str, dp_init, coded_init) -> dict:
    """Every case of the file in one rank; returns what the tests check.
    ``dp_init`` and ``coded_init`` are the reference's parameter trees."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives

    group = mesh.init_ranks(rank, world, device="cpu", store_path=store, timeout_s=120)
    dp = dist.new_group(list(range(DP_RANKS)))
    pair_dp, pair_coded = dist.new_group([0, 1]), dist.new_group([2, 3])
    out = {"backend": dist.get_backend(group)}

    # coded_psum: one weight, then a worker's two terms with two weights.
    w = float(np.float32((rank + 1) / 8))
    out["psum"] = collectives.coded_psum(_psum_tree(rank), w, group)
    out["psum2"] = collectives.coded_psum([_psum_tree(rank), _psum_tree(rank + world)],
                                          [w, 0.5], group)
    # Buckets of 32 bytes: leaves flattened together, flushed, and a leaf
    # larger than a bucket reduced in place in pieces.
    bucket_bytes, collectives.BUCKET_BYTES = collectives.BUCKET_BYTES, 32
    tree = dict(_psum_tree(rank), c=torch.arange(41.0) * (rank + 1))
    out["buckets"] = collectives.all_reduce_tree(tree, group)
    collectives.BUCKET_BYTES = bucket_bytes

    # The vocab-sharded cross-entropy: rank r holds vocab ids [8r, 8r + 8).
    logits, labels = _ce_inputs()
    v = logits.shape[-1] // world
    out["ce"] = collectives.sharded_cross_entropy(logits[..., rank * v:(rank + 1) * v], labels,
                                                  rank * v, group)

    # The data-parallel step on ranks 0-3.
    opt = adamw.AdamWConfig(**OPT)
    if rank < DP_RANKS:
        model, params = _port(DP_ARCH, dp_init)
        step = make_train_step(model, opt, 2, pre_shaped=True, device="cpu", group=dp)
        p, state, m = step(params, adamw.init(params), _batch(_dp_tokens()))
        out["dp"] = dict(params=p, loss=m["loss"], grad_norm=m["grad_norm"], step=state.step)

    # The coded step on all 8 ranks: no straggler, then one (and that
    # pattern's gradient sum).
    model, params = _port(CODED_ARCH, coded_init)
    batch = _batch(_coded_tokens())
    step, code, (pats, ws) = make_coded_train_step(model, opt, world, n_parity=4, seed=0,
                                                   device="cpu", group=group)
    for name, wv in (("none", ws[0]), ("one", _one_straggler(code, pats, ws))):
        p, _, m = step(_clone(params), adamw.init(params), batch, wv)
        out[f"coded_{name}"] = dict(params=p if rank == 0 else None, loss=m["loss"],
                                    first=tree_leaves(p)[0][:2].clone())
    gsum, _ = step.grads(params, batch, _one_straggler(code, pats, ws))
    out["coded_one"]["gsum"] = gsum if rank == 0 else None

    # launch/train --mesh 2,1 on ranks 0-1 (data parallel) and, at the same
    # time, --mesh 2,1 --coded-dp on ranks 2-3.
    if rank < 4:
        coded = ["--coded-dp"] if rank >= 2 else []
        res = train_launch.run(SMOKE + ["--mesh", "2,1"] + coded,
                               group=pair_coded if coded else pair_dp)
        out["launch"] = dict(losses=[h["loss"] for h in res["history"]], rank=res["rank"],
                             ranks=res["ranks"], e_beta=res["sched_e_beta"])
    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device side on the same numpy tokens: its
    inits, its jitted DP step, and on the coded batch each worker's loss
    and gradient, their fp32 sum in worker order and the uncoded
    data-parallel update (that sum over R, AdamW).  JAX is imported here
    only: the spawned ranks import this module."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_config_jax
    from repro.models import build_model as build_model_jax
    from repro.optim import adamw as adamw_jax
    from repro.runtime.train_loop import make_train_step as make_train_step_jax

    def _numpy(tree):
        return jax.tree.map(np.asarray, tree)

    opt = adamw_jax.AdamWConfig(**OPT)
    model = build_model_jax(get_config_jax(DP_ARCH, smoke=True))
    params, _ = model.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(_dp_tokens()).items()}
    step = jax.jit(make_train_step_jax(model, opt, 2, pre_shaped=True))
    p1, _, m1 = step(params, adamw_jax.init(params), batch)
    out = dict(dp_init=_numpy(params), dp_params=_numpy(p1), dp_loss=float(m1["loss"]))

    model = build_model_jax(get_config_jax(CODED_ARCH, smoke=True))
    params, _ = model.init(jax.random.PRNGKey(0))
    tok = _coded_tokens()
    vg = jax.jit(jax.value_and_grad(model.loss_fn))
    gsum, losses = None, []
    for w in range(WORLD):
        loss, g = vg(params, {"tokens": jnp.asarray(tok[w]), "labels": jnp.asarray(tok[w])})
        g = jax.tree.map(lambda x: np.asarray(x, np.float32), g)
        gsum = g if gsum is None else jax.tree.map(np.add, gsum, g)
        losses.append(float(loss))
    grads = jax.tree.map(lambda x: jnp.asarray(x / np.float32(WORLD)), gsum)
    pref, _, _ = adamw_jax.apply(opt, params, grads, adamw_jax.init(params))
    out.update(coded_init=_numpy(params), coded_losses=np.asarray(losses, np.float32),
               coded_gsum=gsum, coded_params=_numpy(pref))
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    return mesh.spawn_ranks(rank_cases, WORLD, reference["dp_init"], reference["coded_init"],
                            timeout_s=400)


def test_coded_psum_sums_the_weighted_leaves(ranks):
    want = tree_map(lambda *xs: sum(np.float32((r + 1) / 8) * x for r, x in enumerate(xs)),
                    *[_psum_tree(r) for r in range(WORLD)])
    want2 = tree_map(lambda *xs: sum(np.float32((r + 1) / 8) * x + 0.5 * y for r, (x, y) in
                                     enumerate(zip(xs[:WORLD], xs[WORLD:]))),
                     *[_psum_tree(r) for r in range(WORLD)],
                     *[_psum_tree(r + WORLD) for r in range(WORLD)])
    for out in ranks:
        for got, exp in zip(tree_leaves(out["psum"]), tree_leaves(want)):
            assert got.dtype == torch.float32 and float((got - exp).abs().max()) < 1e-6
        for got, exp in zip(tree_leaves(out["psum2"]), tree_leaves(want2)):
            assert float((got - exp).abs().max()) < 1e-6
    small = ranks[0]["buckets"]
    assert torch.equal(small["c"], torch.arange(41.0) * sum(range(1, WORLD + 1)))
    for got, exp in zip(tree_leaves([small["a"], small["b"]]),
                        tree_leaves(tree_map(lambda *xs: sum(xs),
                                             *[_psum_tree(r) for r in range(WORLD)]))):
        assert float((got - exp).abs().max()) < 1e-5
    # every rank holds the same sum, bit for bit
    assert all(torch.equal(a, b) for out in ranks[1:]
               for a, b in zip(tree_leaves(out["psum"]), tree_leaves(ranks[0]["psum"])))


def test_sharded_cross_entropy_equals_the_dense_one(ranks):
    logits, labels = _ce_inputs()
    dense = float(cross_entropy(logits, labels))
    for out in ranks:
        assert abs(float(out["ce"]) - dense) < 1e-5


def test_data_parallel_step_matches_the_reference_and_the_one_process_step(reference, ranks):
    model, params = _port(DP_ARCH, reference["dp_init"])
    want = interop.lm_params_from_numpy(model.cfg, reference["dp_params"], "cpu")
    p1, _, m1 = make_train_step(model, adamw.AdamWConfig(**OPT), 2, pre_shaped=True,
                                device="cpu")(params, adamw.init(params), _batch(_dp_tokens()))
    for out in ranks[:DP_RANKS]:
        dp = out["dp"]
        assert dp["step"] == 1
        assert abs(float(dp["loss"]) - reference["dp_loss"]) < 1e-4
        assert abs(float(dp["loss"]) - float(m1["loss"])) < 1e-4
        assert _max_err(want, dp["params"]) < 2e-4
        assert _max_err(p1, dp["params"]) < 2e-4
    for out in ranks[1:DP_RANKS]:  # the ranks apply one update
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out["dp"]["params"]),
                                                     tree_leaves(ranks[0]["dp"]["params"])))


@pytest.mark.parametrize("pattern", ["none", "one"])
def test_coded_step_across_ranks_matches_the_reference_and_the_workers_in_turn(
        reference, ranks, pattern):
    model, params = _port(CODED_ARCH, reference["coded_init"])
    step, code, (pats, ws) = make_coded_train_step(model, adamw.AdamWConfig(**OPT), WORLD,
                                                   n_parity=4, seed=0, device="cpu")
    wv = ws[0] if pattern == "none" else _one_straggler(code, pats, ws)
    if pattern == "one":
        assert np.count_nonzero(wv[:WORLD] == 0) == 1
    got = ranks[0][f"coded_{pattern}"]
    # The reference: the uncoded update, and the loss its coded step reports
    # (each worker's own loss times its weight, summed, over R).
    want = interop.lm_params_from_numpy(model.cfg, reference["coded_params"], "cpu")
    assert _max_err(want, got["params"]) < 5e-5
    ref_loss = float(np.dot(wv[:WORLD], reference["coded_losses"])) / WORLD
    assert abs(float(got["loss"]) - ref_loss) <= LOSS_RTOL * abs(ref_loss) and ref_loss > 0
    # The port's workers in turn.
    p, _, m = step(_clone(params), adamw.init(params), _batch(_coded_tokens()), wv)
    assert _max_err(p, got["params"]) < 5e-5
    assert abs(float(got["loss"]) - float(m["loss"])) < 1e-5
    assert all(torch.equal(out[f"coded_{pattern}"]["first"], got["first"]) for out in ranks)


def test_one_straggler_gradient_sum_across_ranks(reference, ranks):
    """The R-of-(R+K) decode across ranks with a worker's own gradient
    dropped: within 1e-4 of the reference's uncoded sum (a leaf's max) and
    1e-5 of the port's in-turn sum."""
    model, params = _port(CODED_ARCH, reference["coded_init"])
    step, code, (pats, ws) = make_coded_train_step(model, adamw.AdamWConfig(**OPT), WORLD,
                                                   n_parity=4, seed=0, device="cpu")
    g_turn, _ = step.grads(params, _batch(_coded_tokens()), _one_straggler(code, pats, ws))
    got = ranks[0]["coded_one"]["gsum"]
    want = interop.lm_params_from_numpy(model.cfg, reference["coded_gsum"], "cpu")
    for a, b, c in zip(tree_leaves(got), tree_leaves(want), tree_leaves(g_turn)):
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())
        assert float((a - c).abs().max()) <= 1e-5 * float(c.abs().max())


@pytest.mark.parametrize("device, local, cards, want", [
    ("cpu", 8, 0, "gloo"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 4, 8, "nccl"),
    ("cuda", 4, 1, "gloo"),
    ("cuda:0", 4, 4, "gloo"),
    ("cuda:0", 1, 4, "nccl"),
])
def test_backend_takes_nccl_only_for_a_card_a_rank(monkeypatch, device, local, cards, want):
    """NCCL refuses two ranks on one card: ranks given one card by index,
    or more local ranks than cards, share and take gloo."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh.backend_for(device, 2 * local) == want


def test_every_rank_took_gloo_on_the_cpu(ranks):
    assert all(out["backend"] == "gloo" for out in ranks)


def test_launch_train_mesh_2_1_on_two_ranks(ranks):
    """--mesh 2,1 trains data parallel on 2 ranks as the one-process run of
    the same global batch does; --coded-dp on 2 ranks as the in-turn coded
    run; the scheduler hears both ranks' step times."""
    one = train_launch.run(SMOKE)
    turn = train_launch.run(SMOKE + ["--mesh", "2,1", "--coded-dp"])
    for r, ref in ((0, one), (1, one), (2, turn), (3, turn)):
        got = ranks[r]["launch"]
        assert got["ranks"] == 2 and got["rank"] == r % 2 and got["e_beta"].shape == (2,)
        want = [h["loss"] for h in ref["history"]]
        assert np.allclose(got["losses"], want, rtol=1e-5, atol=0), (r, got["losses"], want)
