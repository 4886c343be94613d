"""The train step with a pod axis and FSDP weights (slice C6a) across four
gloo ranks on the CPU, held to the reference.

One spawn of 4 ranks makes a ``(pod 2, data 2, model 1)`` mesh.  Each rank
takes one row of each microbatch (``batch_spec`` splits it over pod x
data).  The config is qwen3-235b's smoke config, with the rules' ``ff``
put on 'data' as they put it at full width: the experts' ff dim is FSDP,
gathered over 'data' before use, its gradient summed over pod x data in
the backward and sliced back.  The step's gradients, gathered whole, and
its loss are held to the reference's single-device step at the training
anchors (loss within 1e-5 relative, each gradient leaf within 1e-4 of its
max |g|, as ``tests/test_torch_tp.py``); the parameters after AdamW
(ZeRO-1 moments over 'data', alike over 'pod'; an FSDP leaf's moments its
own shard) within 2e-4 of the one-process AdamW of the reference's
gradient.  The smoke
config's capacity factor (8 of 8 experts, top 2) drops no assignment, so
the reference's global capacity and the port's capacity a data shard
agree (``ROADMAP.md``, deliberate differences).
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import mesh
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.parallel import tensor as tp
from repro_torch.runtime.train_loop import make_train_step

ARCH = "qwen3-moe-235b-a22b"
OPT = dict(lr=1e-3, warmup_steps=0, schedule="constant", weight_decay=0.0)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _tokens() -> np.ndarray:
    """2 microbatches of 4 x 16 uniform tokens."""
    vocab = get_config(ARCH, smoke=True).vocab
    return np.random.default_rng(5).integers(0, vocab, size=(2, 4, 16)).astype(np.int32)


def _rank(rank: int, world: int, store: str, init) -> dict:
    import torch.distributed as dist

    mesh.init_ranks(rank, world, device="cpu", store_path=store, timeout_s=180)
    dmesh = mesh.make_device_mesh(2, 1, pod=2)
    model = build_model(get_config(ARCH, smoke=True))
    params = interop.lm_params_from_numpy(model.cfg, init, "cpu")
    _, axes = model.init(None, with_axes=True)
    rules = dict(sharding.make_rules(model.cfg, dmesh), ff="data")
    p = tp.place_tree(params, sharding.param_shardings(dmesh, axes, rules))
    fsdp = sorted({str(x.placements) for x in tree_leaves(p) if tp.data_shard_dim(x) is not None})
    o = adamw.init(p, sharding.opt_state_shardings(dmesh, axes, rules, params))
    step = make_train_step(model, adamw.AdamWConfig(**OPT), 2, pre_shaped=True, device="cpu",
                           mesh=dmesh)
    tok = torch.as_tensor(_tokens())
    batch = {"tokens": tok, "labels": tok}
    tp.reset_counts()
    grads, loss = step.grads(p, batch)
    counts = tp.counts()
    grads = tp.gather_tree(grads)
    p, o, m = step(p, o, batch)
    out = dict(loss=float(loss), step_loss=float(m["loss"]), counts=counts, fsdp=fsdp,
               coord=dmesh.get_coordinate())
    full = tp.gather_tree(p)
    if rank == 0:
        out.update(grads=grads, params=full)
    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's init, and the loss and gradient of its train step:
    the mean over the two microbatches of its jitted ``loss_fn``'s."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_config_jax
    from repro.models import build_model as build_model_jax

    model = build_model_jax(get_config_jax(ARCH, smoke=True))
    # numpy draws in the shapes of the reference's init (its own draws take
    # seconds on the CPU): norm scales near 1, weights 0.05 N(0, 1)
    shapes = jax.eval_shape(lambda k: model.init(k)[0], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: (1.0 + 0.1 * rng.standard_normal(s.shape) if len(s.shape) == 1
                                     else 0.05 * rng.standard_normal(s.shape)).astype(np.float32),
                          shapes)
    tok = jnp.asarray(_tokens())

    vg = jax.jit(jax.value_and_grad(model.loss_fn))
    parts = [vg(params, {"tokens": t, "labels": t}) for t in tok]
    n = len(parts)
    grads = jax.tree.map(lambda *g: sum(np.asarray(x, np.float32) for x in g) / n,
                         *[g for _, g in parts])
    return dict(init=jax.tree.map(np.asarray, params), grads=grads,
                loss=sum(float(v) for v, _ in parts) / n)


@pytest.fixture(scope="module")
def ranks(reference):
    return mesh.spawn_ranks(_rank, 4, reference["init"], timeout_s=300)


def test_pod_and_fsdp_step_matches_the_reference(reference, ranks):
    cfg = get_config(ARCH, smoke=True)
    want_g = interop.lm_params_from_numpy(cfg, reference["grads"], "cpu")
    got = ranks[0]
    for key in ("loss", "step_loss"):
        assert abs(got[key] - reference["loss"]) <= LOSS_RTOL * abs(reference["loss"])
    for a, b in zip(tree_leaves(got["grads"]), tree_leaves(want_g)):
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())
    # the update: the one-process AdamW (held to the reference's in
    # tests/test_torch_optim.py) of the reference's gradient
    init = interop.lm_params_from_numpy(cfg, reference["init"], "cpu")
    want_p, _, _ = adamw.apply(adamw.AdamWConfig(**OPT), init, want_g, adamw.init(init))
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(want_p)):
        assert float((a - b).abs().max()) < 2e-4
    for out in ranks:  # every rank the same loss
        assert out["loss"] == got["loss"] and out["step_loss"] == got["step_loss"]


def test_mesh_layout_and_collectives(ranks):
    """Ranks 0-3 sit at (pod, data, model) = (0,0,0), (0,1,0), (1,0,0),
    (1,1,0); the experts' weights are split over 'data' and alike over
    'pod'; each microbatch gathers them once (the model has no remat) and
    sums their gradient over pod x data in its backward; the rest is
    averaged in the step's all-reduce."""
    assert [tuple(o["coord"]) for o in ranks] == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    for out in ranks:
        assert out["fsdp"] and all("Replicate()" in f.split(",")[0] for f in out["fsdp"])
        counts = out["counts"]
        n_fsdp = 3 * get_config(ARCH, smoke=True).n_layers  # w_gate, w_up, w_down a layer
        assert counts["fsdp_gather"][0] == 2 * n_fsdp
        assert counts["fsdp_grad_all_reduce"][0] == 2 * n_fsdp
        assert counts["data_all_reduce"][0] >= 1
