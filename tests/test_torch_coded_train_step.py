"""The coded data-parallel train step of the port
(``repro_torch.runtime.train_loop.make_coded_train_step``), in process:
``tests/test_coded_train_step.py``'s setup (mistral-nemo-12b smoke, R=8
workers, 4 parities, microbatches of 2 x 16 tokens) and bounds.  With no
straggler, and with one worker's own gradient dropped and decode weights
that exclude it, the update must be within 5e-5 of the uncoded
data-parallel update, as the reference's is; the code and its weight table
are the reference's (``tests/test_torch_gradient_coding.py``).  Also: the
no-straggler gradient sum equals the uncoded one bit for bit (weights 1 and
0, summed in worker order), a one-straggler sum within 1e-5 of its max |.|
(float32 decode weights)."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import numpy as np
import pytest
import torch

from repro.core import gradient_coding as gc_jax
from repro_torch.configs import get_config
from repro_torch.core import gradient_coding as gc
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import make_coded_train_step, value_and_grad

R, N_PARITY, TOL = 8, 4, 5e-5


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("mistral-nemo-12b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant", weight_decay=0.0)
    step, code, (pats, ws) = make_coded_train_step(model, opt_cfg, R, n_parity=N_PARITY, seed=0,
                                                   device="cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, size=(R, 2, 16)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(tok), "labels": torch.as_tensor(tok)}
    gsum = None
    for r in range(R):
        _, g = value_and_grad(model.loss_fn, params, {k: v[r] for k, v in batch.items()})
        gsum = g if gsum is None else tree_map(lambda a, b: a + b, gsum, g)
    pref, _, _ = adamw.apply(opt_cfg, _clone(params), tree_map(lambda g: g / R, gsum),
                             adamw.init(params))
    return dict(model=model, params=params, step=step, code=code, pats=pats, ws=ws,
                batch=batch, gsum=gsum, pref=pref)


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def _one_straggler(s):
    """The reference test's pattern: the table's first one that drops
    exactly one systematic result, else decode weights without worker 0."""
    for pat, w in zip(s["pats"][1:], s["ws"][1:]):
        if len(np.flatnonzero(~pat[:R])) == 1:
            return w
    surv = np.setdiff1d(np.arange(R + s["code"].K), [0])
    w = np.zeros(R + s["code"].K, np.float32)
    w[surv] = gc.decode_weights(s["code"], surv)
    return w


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a),
                                                         tree_leaves(b)))


def test_code_and_weight_table_are_the_references(setup):
    ref = gc_jax.make_gradient_code(R, N_PARITY, seed=0)
    np.testing.assert_array_equal(setup["code"].idx, ref.idx)
    np.testing.assert_array_equal(setup["code"].coef, ref.coef)
    pats, ws = gc_jax.weight_table(ref, max_stragglers=max(1, N_PARITY // 2), seed=0)
    np.testing.assert_array_equal(setup["pats"], pats)
    np.testing.assert_array_equal(setup["ws"], ws)


@pytest.mark.parametrize("pattern", ["no_straggler", "one_straggler"])
def test_coded_step_matches_uncoded(setup, pattern):
    s = setup
    w = s["ws"][0] if pattern == "no_straggler" else _one_straggler(s)
    if pattern == "one_straggler":
        assert np.count_nonzero(w[:R] == 0) == 1
    p, state, m = s["step"](_clone(s["params"]), adamw.init(s["params"]), s["batch"], w)
    assert _max_err(s["pref"], p) < TOL
    assert float(m["loss"]) > 0 and state.step == 1


def test_coded_gradient_sums(setup):
    s = setup
    g0, loss0 = s["step"].grads(s["params"], s["batch"], s["ws"][0])
    for a, b in zip(tree_leaves(g0), tree_leaves(s["gsum"])):
        assert torch.equal(a, b)
    g1, _ = s["step"].grads(s["params"], s["batch"], _one_straggler(s))
    for a, b in zip(tree_leaves(g1), tree_leaves(s["gsum"])):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert float(loss0) > 0
