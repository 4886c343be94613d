"""Port parity for the optimizer (``repro_torch.optim.adamw``): the
reference's own tests (``tests/test_optim.py``) on the port, and the port
against ``repro.optim.adamw`` on the same numpy inputs.

Tolerances: the schedule, the global norm and three AdamW steps rtol 1e-6
(atol 1e-7 on the moments and parameters): the same float32 formulas, but
XLA's CPU build contracts some multiply-adds into FMAs and sums the leaves'
squares in its own order, so the last bit can differ; the clip scale then
moves every scaled gradient by an ulp or so.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as adamw_jax
from repro_torch import interop
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw

RTOL, ATOL = 1e-6, 1e-7


# --- the reference's tests, on the port ----------------------------------------

def test_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                            schedule="cosine", min_lr_frac=0.1)
    lrs = [float(adamw.schedule_lr(cfg, s)) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9          # warmup peak
    assert lrs[100] < lrs[50] < lrs[10]        # monotone decay
    assert abs(lrs[100] - 1e-4) < 1e-6         # min_lr_frac floor


def test_adamw_reduces_quadratic():
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                            total_steps=1000, schedule="constant")
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}  # the gradient of sum(w ** 2)
        params, state, _ = adamw.apply(cfg, params, g, state)
    assert float((params["w"] ** 2).sum()) < 1e-3


def test_clip_norm_applies():
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0,
                            schedule="constant", weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw.init(params)
    g = {"w": torch.full((4,), 100.0)}
    p2, state, metrics = adamw.apply(cfg, params, g, state)
    assert float(metrics["grad_norm"]) > 100
    assert float(p2["w"].abs().max()) < 2.0


def test_mixed_dtype_params_keep_dtype():
    cfg = adamw.AdamWConfig(warmup_steps=0)
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(3)}
    state = adamw.init(params)
    g = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(3)}
    p2, state, _ = adamw.apply(cfg, params, g, state)
    assert p2["a"].dtype == torch.bfloat16
    assert p2["b"].dtype == torch.float32
    assert state.m["a"].dtype == torch.float32   # moments always fp32
    assert state.step == 1


def test_apply_updates_in_place_and_reports_each_leaf():
    cfg = adamw.AdamWConfig(warmup_steps=0)
    params = {"w": torch.ones(3), "z": [torch.ones(2)]}
    state = adamw.init(params)
    w, m = params["w"], state.m["w"]
    g = {"w": torch.tensor([1.0, 0.0, -2.0]), "z": [torch.zeros(2)]}
    p2, s2, metrics = adamw.apply(cfg, params, g, state)
    assert p2["w"] is w and s2.m["w"] is m and not torch.equal(w, torch.ones(3))
    torch.testing.assert_close(metrics["grad_leaf_sq"], torch.tensor([5.0, 0.0]))


# --- against the reference ------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    for kw in (dict(warmup_steps=10, total_steps=100), dict(warmup_steps=0, total_steps=7),
               dict(warmup_steps=3, total_steps=3)):
        cfg = dict(lr=3e-3, schedule=schedule, min_lr_frac=0.1, **kw)
        ours = adamw.AdamWConfig(**cfg)
        ref = adamw_jax.AdamWConfig(**cfg)
        for s in range(0, 110, 3):
            got = adamw.schedule_lr(ours, s)
            want = np.asarray(adamw_jax.schedule_lr(ref, jnp.asarray(s, jnp.int32)))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal((3,)) * scale).astype(np.float32)},
            "l": [(rng.standard_normal((4, 2)) * scale).astype(np.float32),
                  np.zeros((2,), np.float32)]}


def _t(tree):
    return tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def _close(port_tree, ref_tree):
    ref = jax.tree.leaves(ref_tree)
    ours = tree_leaves(port_tree)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(0), 3.0)
    np.testing.assert_allclose(float(adamw.global_norm(_t(tree))),
                               float(adamw_jax.global_norm(jax.tree.map(jnp.asarray, tree))),
                               rtol=RTOL)


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_apply_matches_reference_for_three_steps(clip_norm):
    """Three steps of cosine-scheduled, clipped AdamW with weight decay on
    the same numpy parameters and gradients (large enough for the clip to
    act); each step's parameters, moments and metrics against the
    reference's, and the reference's state carried across
    (``interop.adamw_state_from_numpy``) equal to the port's."""
    rng = np.random.default_rng(1)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, schedule="cosine", clip_norm=clip_norm,
               weight_decay=0.1)
    params = _tree(rng)
    p_ref = jax.tree.map(jnp.asarray, params)
    s_ref = adamw_jax.init(p_ref)
    p_pt = _t(params)
    s_pt = adamw.init(p_pt)
    for step in range(3):
        grads = _tree(rng, 4.0)
        p_ref, s_ref, m_ref = adamw_jax.apply(adamw_jax.AdamWConfig(**cfg), p_ref,
                                              jax.tree.map(jnp.asarray, grads), s_ref)
        p_pt, s_pt, m_pt = adamw.apply(adamw.AdamWConfig(**cfg), p_pt, _t(grads), s_pt)
        _close(p_pt, p_ref)
        _close(s_pt.m, s_ref.m)
        _close(s_pt.v, s_ref.v)
        assert s_pt.step == int(s_ref.step) == step + 1
        np.testing.assert_allclose(float(m_pt["grad_norm"]), float(m_ref["grad_norm"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(m_pt["lr"]), float(m_ref["lr"]), rtol=RTOL)
    carried = interop.adamw_state_from_numpy(jax.tree.map(np.asarray, s_ref), device="cpu")
    assert carried.step == s_pt.step
    _close(carried.m, s_ref.m)
    for a, b in zip(tree_leaves(carried.v), tree_leaves(s_pt.v)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_init_matches_reference():
    params = _tree(np.random.default_rng(2))
    s_ref = adamw_jax.init(jax.tree.map(jnp.asarray, params))
    s_pt = adamw.init(_t(params))
    assert s_pt.step == int(s_ref.step) == 0
    for a, b in zip(tree_leaves(s_pt.m) + tree_leaves(s_pt.v),
                    jax.tree.leaves(s_ref.m) + jax.tree.leaves(s_ref.v)):
        assert a.dtype == torch.float32 and a.shape == b.shape and not a.any()
