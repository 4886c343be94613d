"""Port parity for the MoE block (``repro_torch.models.moe``) on the CPU:
its output and Switch aux loss against the jitted reference on the
reference's weights, at TOL = 2e-5 (the same fp32 arithmetic, products
summed in another order), at the two MoE smoke configs, at a capacity
factor of 1.25 (tokens drop at capacity) and with a router softcap.  The
port's combine reads each (token, choice)'s slot and sums in a fixed order,
so two runs are bitwise equal.  Also ``tests/test_models_smoke.py``'s
``test_moe_active_params`` and the refusal of the all-to-all formulation.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import common as common_jax
from repro.models import moe as moe_jax
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.config import MoEConfig

TOL = 2e-5

CASES = {
    "moonshot-smoke": ("moonshot-v1-16b-a3b", {}),
    "qwen3-moe-smoke": ("qwen3-moe-235b-a22b", {}),
    "moonshot-capacity-1.25": ("moonshot-v1-16b-a3b", {"capacity_factor": 1.25}),
    "qwen3-softcap": ("qwen3-moe-235b-a22b", {"router_softcap": 5.0,
                                              "capacity_factor": 1.25}),
}


def _cfgs(arch, **moe_kw):
    cfg_j, cfg = get_config_jax(arch, smoke=True), get_config(arch, smoke=True)
    if moe_kw:
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg_j, cfg


def _setup(arch, moe_kw, seed=1, B=4, T=16):
    cfg_j, cfg = _cfgs(arch, **moe_kw)
    pb = common_jax.ParamBuilder(key=jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, common_jax.unzip_params(moe_jax.init_moe(pb, cfg_j))[0])
    x = np.random.default_rng(seed).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return cfg_j, cfg, params, {k: torch.tensor(v) for k, v in params.items()}, x


def _dropped(params, x, cfg):
    """Assignments beyond their expert's capacity, counted directly."""
    S = x.shape[0] * x.shape[1]
    _, _, top_e = moe.route(params, torch.as_tensor(x).reshape(S, -1), cfg)
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.moe.n_experts)
    return int(torch.clamp(counts - moe._capacity(S, cfg.moe), min=0).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_reference(case):
    arch, moe_kw = CASES[case]
    cfg_j, cfg, params, pt, x = _setup(arch, moe_kw)
    out_j, aux_j = jax.jit(moe_jax.moe_block, static_argnums=(2,))(params, jnp.asarray(x), cfg_j)
    out, aux = moe.moe_block(pt, torch.as_tensor(x), cfg)
    assert out.shape == x.shape and aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=TOL, atol=TOL)
    drops = _dropped(pt, x, cfg)
    if cfg.moe.capacity_factor < 2:
        assert drops > 0, "the case must drop tokens at capacity"
    else:
        assert drops == 0


def test_moe_combine_is_bitwise_repeatable_and_counts_drops():
    cfg_j, cfg, _, pt, x = _setup("moonshot-v1-16b-a3b", {"capacity_factor": 1.25}, seed=3)
    xt = torch.as_tensor(x)
    moe.set_moe_opts(count_drops=True)
    moe.moe_block.dropped = 0
    try:
        a, aux_a = moe.moe_block(pt, xt, cfg)
        b, aux_b = moe.moe_block(pt, xt, cfg)
        assert int(moe.moe_block.dropped) == 2 * _dropped(pt, x, cfg) > 0
    finally:
        moe.set_moe_opts()
        moe.moe_block.dropped = 0
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_moe_gradients_match_reference():
    """jax.grad of the block's output and aux against torch's backward,
    per leaf within 1e-4 of its max |.|."""
    cfg_j, cfg, params, pt, x = _setup("moonshot-v1-16b-a3b", {"capacity_factor": 1.25}, seed=5)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def f_j(p, x):
        out, aux = moe_jax.moe_block(p, x, cfg_j)
        return jnp.sum(out * w) + aux

    gj = jax.jit(jax.grad(f_j, argnums=(0, 1)))(params, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    xt = torch.as_tensor(x).requires_grad_(True)
    out, aux = moe.moe_block(leaves, xt, cfg)
    (torch.sum(out * torch.as_tensor(w)) + aux).backward()
    for got, want in [(leaves[k].grad, gj[0][k]) for k in leaves] + [(xt.grad, gj[1])]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-30))


def test_moe_active_params():
    cfg = get_config("qwen3-moe-235b-a22b")
    act = cfg.n_active_params()
    assert 15e9 < act < 30e9, act  # ~22B active


def test_capacity_matches_reference():
    for S, m in [(32, MoEConfig(8, 2, 48)), (4, MoEConfig(64, 6, 1408, 2)),
                 (2044, MoEConfig(64, 6, 1408, 2)), (7, MoEConfig(128, 8, 1536, 0, 8.0))]:
        assert moe._capacity(S, m) == moe_jax._capacity(S, m)


def test_all_to_all_formulation_waits_for_the_multi_rank_slice(monkeypatch):
    """set_moe_opts(a2a_mesh=...) sends every MoE block to
    moe_a2a.moe_block_a2a on that mesh (held to the reference across ranks
    in tests/test_torch_moe_a2a.py); constrain is a sharding hint with
    nothing to do on one card."""
    from repro_torch.models import moe_a2a

    calls = []
    monkeypatch.setattr(moe_a2a, "moe_block_a2a",
                        lambda p, x, cfg, mesh: calls.append(mesh) or (x, torch.zeros(())))
    sentinel = object()
    moe.set_moe_opts(a2a_mesh=sentinel)
    try:
        cfg_j, cfg, _, pt, x = _setup("qwen3-moe-235b-a22b", {})
        out, _ = moe.moe_block(pt, torch.as_tensor(x), cfg)
    finally:
        moe.set_moe_opts()
    assert calls == [sentinel] and torch.equal(out, torch.as_tensor(x))
    moe.set_moe_opts(constrain=True)
    try:
        cfg_j, cfg, _, pt, x = _setup("qwen3-moe-235b-a22b", {})
        a, _ = moe.moe_block(pt, torch.as_tensor(x), cfg)
    finally:
        moe.set_moe_opts()
    b, _ = moe.moe_block(pt, torch.as_tensor(x), cfg)
    assert torch.equal(a, b) and moe.MOE_OPTS == {"constrain": False, "a2a_mesh": None,
                                                  "count_drops": False}
