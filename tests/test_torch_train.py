"""Port parity for LM training (``repro_torch.runtime.train_loop``): the
microbatched train step against the reference's jitted
``repro.runtime.train_loop.make_train_step`` on mistral-nemo-12b smoke and
gemma2-27b smoke (local/global attention with window 8, attention softcap
50, post-block norms, final softcap 30), two microbatches, on the
reference's own weights; remat against none; and the counterpart of
``tests/test_system.py::test_training_learns``.

Tolerances.  A step is held on its loss (1e-5 relative) and its gradients
(each leaf within 1e-4 of the leaf's max |g_ref|): fp32 sums in another
order by another library, through two to four layers.  The parameters
after the step are not compared directly: at step 1 AdamW's update is
about sign(g) lr, so a gradient element within rounding of zero moves by
up to 2 lr.  The optimizer is held apart, on the reference's own
gradients given to both (parameters rtol 1e-6, atol 1e-7, as in
tests/test_torch_optim.py).  Remat recomputes the same CPU arithmetic:
equal to the last bit.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import build_model as build_model_jax
from repro.optim import adamw as adamw_jax
from repro.runtime.train_loop import make_train_step as make_train_step_jax
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
OPT = dict(lr=5e-3, warmup_steps=1, total_steps=10, weight_decay=0.01)


@pytest.fixture(scope="module", params=["mistral-nemo-12b", "gemma2-27b"])
def reference_step(request):
    """The reference's weights, its microbatch gradients (value_and_grad of
    its loss per microbatch, summed in fp32 and halved, as its step's scan
    does) and its jitted step's metrics and update on 8 sequences of 16
    uniform random tokens in 2 microbatches.  (Not the synthetic stream:
    its Zipf unigram puts nearly all mass on a few tokens, so most
    sequences repeat one token, every value row is alike, and the query
    and key projections' gradients are rounding noise, 1e-9 of the others.)"""
    arch = request.param
    cfg = get_config_jax(arch, smoke=True)
    model = build_model_jax(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, size=(2, 4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    vg = jax.jit(jax.value_and_grad(model.loss_fn))
    gsum, losses = None, []
    for i in range(2):
        loss, g = vg(params, {k: jnp.asarray(v[i]) for k, v in batch.items()})
        g = jax.tree.map(lambda x: np.asarray(x, np.float32), g)
        gsum = g if gsum is None else jax.tree.map(np.add, gsum, g)
        losses.append(float(loss))
    grads = jax.tree.map(lambda x: x / np.float32(2), gsum)
    opt_cfg = adamw_jax.AdamWConfig(**OPT)
    step = jax.jit(make_train_step_jax(model, opt_cfg, 2, pre_shaped=True))
    state = adamw_jax.init(params)
    new_params, _, metrics = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    p_opt, s_opt, _ = adamw_jax.apply(opt_cfg, params, jax.tree.map(jnp.asarray, grads), state)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(arch=arch, params=to_np(params), batch=batch, grads=grads,
                loss=float(np.mean(losses)), metrics=to_np(metrics),
                p_opt=to_np(p_opt), s_opt=to_np(s_opt))


def _port(arch, ref, **kw):
    cfg = get_config(arch, smoke=True)
    return cfg, build_model(cfg, **kw), interop.lm_params_from_numpy(cfg, ref["params"], "cpu")


def _leaf_close(ours, ref_tree, cfg, tol):
    want = tree_leaves(interop.lm_params_from_numpy(cfg, ref_tree, "cpu"))
    got = tree_leaves(ours)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), \
            float((a - b).abs().max()) / float(b.abs().max())


def test_microbatch_gradients_and_loss_match_the_reference(reference_step):
    ref = reference_step
    cfg, model, params = _port(ref["arch"], ref)
    micro = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    grads, loss = train_loop.accumulate_grads(model, params, micro)
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    _leaf_close(grads, ref["grads"], cfg, GRAD_TOL)


def test_train_step_metrics_match_the_reference_jitted_step(reference_step):
    ref = reference_step
    cfg, model, params = _port(ref["arch"], ref)
    step = train_loop.make_train_step(model, adamw.AdamWConfig(**OPT), 2, pre_shaped=True,
                                      device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    new_params, state, metrics = step(params, adamw.init(params), ref["batch"])
    assert state.step == 1 and new_params is params
    m = ref["metrics"]
    assert abs(float(metrics["loss"]) - float(m["loss"])) <= LOSS_RTOL * abs(float(m["loss"]))
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(m["grad_norm"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["lr"]), float(m["lr"]), rtol=1e-6)
    sq = metrics["grad_leaf_sq"]
    assert sq.shape == (len(before),) and bool(torch.isfinite(sq).all()) and bool((sq > 0).all())
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))


def test_adamw_on_the_reference_gradients_matches_the_reference(reference_step):
    ref = reference_step
    cfg, _, params = _port(ref["arch"], ref)
    grads = interop.lm_params_from_numpy(cfg, ref["grads"], "cpu")
    p, state, _ = adamw.apply(adamw.AdamWConfig(**OPT), params, grads, adamw.init(params))
    want = interop.lm_params_from_numpy(cfg, ref["p_opt"], "cpu")
    for a, b in zip(tree_leaves(p), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    carried = interop.adamw_state_from_numpy(ref["s_opt"], cfg=cfg, device="cpu")
    assert carried.step == state.step == 1
    for a, b in zip(tree_leaves(state.v), tree_leaves(carried.v)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_eval_step_is_the_loss(reference_step):
    ref = reference_step
    _, model, params = _port(ref["arch"], ref)
    b = {k: v[0] for k, v in ref["batch"].items()}
    got = train_loop.make_eval_step(model, device="cpu")(params, b)
    want = model.loss_fn(params, {k: torch.as_tensor(v) for k, v in b.items()})
    assert torch.equal(got, want) and not got.requires_grad


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_gradients_without_remat(policy):
    cfg = get_config("gemma2-27b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    batch = SyntheticLM(cfg.vocab, 16, 4, seed=1).batch(0)
    b = {k: torch.as_tensor(v[0]) for k, v in batch.items()}
    loss0, g0 = train_loop.value_and_grad(build_model(cfg).loss_fn, params, b)
    loss1, g1 = train_loop.value_and_grad(
        build_model(cfg, remat=True, remat_policy=policy).loss_fn, params, b)
    assert torch.equal(loss0, loss1)
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, c)


def test_training_learns():
    """The counterpart of tests/test_system.py::test_training_learns: 40
    steps on the synthetic stream, the mean loss of the last 5 at least 0.5
    below that of the first 5."""
    cfg = get_config("mistral-nemo-12b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=60, weight_decay=0.01)
    data = SyntheticLM(cfg.vocab, seq_len=32, global_batch=8, n_micro=2, seed=0)
    step = train_loop.make_train_step(model, opt_cfg, 2, pre_shaped=True, device="cpu")
    opt_state = adamw.init(params)
    losses = []
    for s in range(40):
        params, opt_state, m = step(params, opt_state, data.batch(s))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.5, f"loss did not decrease: {first} -> {last}"


def test_train_step_refuses_params_on_another_device():
    cfg = get_config("mistral-nemo-12b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    step = train_loop.make_train_step(model, adamw.AdamWConfig(), device=torch.device("meta"))
    with pytest.raises(ValueError, match="parameters are on cpu"):
        step(params, adamw.init(params), SyntheticLM(cfg.vocab, 8, 2).batch(0))
