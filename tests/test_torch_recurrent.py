"""Port parity for the recurrent mixers (``repro_torch.models.rglru`` and
``repro_torch.models.xlstm``) on the CPU.

First ``tests/test_recurrent_cells.py`` case for case against the port, at
the reference's own tolerances: the RG-LRU's log-depth scan against a
step-by-step recurrence, chunked prefill with a carried state against one
shot, token-by-token decode against the full pass, xLSTM's streaming
against its full pass, and the mLSTM state's size.  Then the port against
the jitted reference on the reference's weights, at TOL = 2e-5 (the same
fp32 arithmetic, products summed in another order by another library): the
RG-LRU block one-shot, chunked and token by token; the scan alone at long
T; mLSTM and sLSTM full and streaming, their returned states included.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as get_config_jax
from repro.models import common as common_jax
from repro.models import rglru as rg_jax
from repro.models import xlstm as xl_jax
from repro_torch.configs import get_config
from repro_torch.models import rglru as rg
from repro_torch.models import xlstm as xl
from repro_torch.models.common import ACT, ParamBuilder

TOL = 2e-5


def _ref_params(init_fn, cfg, seed):
    """The reference's block weights (its init on PRNGKey(seed)), as numpy."""
    pb = common_jax.ParamBuilder(key=jax.random.PRNGKey(seed))
    return {k: np.asarray(v[0]) for k, v in init_fn(pb, cfg).items()}


def _t(params):
    return {k: torch.tensor(v) for k, v in params.items()}


def _close(out_t, ref_j, tol=TOL):
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(ref_j), rtol=tol, atol=tol)


def _x(seed, shape, scale):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# --- tests/test_recurrent_cells.py, against the port ----------------------------

@pytest.fixture(scope="module")
def rg_setup():
    cfg = get_config("recurrentgemma-2b", smoke=True)
    pb = ParamBuilder(torch.Generator().manual_seed(0))
    return cfg, rg.init_rglru_block(pb, cfg)


def _rglru_sequential(params, xs, cfg):
    """Literal per-step reference of the RG-LRU recurrence (the reference
    test's oracle, in torch)."""
    gate = ACT["gelu"](xs @ params["w_gate"])
    u = xs @ params["w_x"]
    cw = cfg.conv_width
    xp = torch.cat([torch.zeros((xs.shape[0], cw - 1, u.shape[-1])), u], dim=1)
    conv = sum(xp[:, i: i + u.shape[1], :] * params["conv"][i][None, None]
               for i in range(cw)) + params["conv_b"][None, None]
    B, T, W = conv.shape
    h = torch.zeros((B, W))
    outs = []
    for t in range(T):
        x_t = conv[:, t]
        r = torch.sigmoid(x_t @ params["wa"] + params["ba"])
        i = torch.sigmoid(x_t @ params["wi"] + params["bi"])
        log_a = -8.0 * torch.nn.functional.softplus(params["lam"])[None, :] * r
        a = torch.exp(log_a)
        h = a * h + torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=0.0)) * (i * x_t)
        outs.append(h)
    return (torch.stack(outs, dim=1) * gate) @ params["w_down"]


def test_rglru_assoc_scan_matches_sequential(rg_setup):
    cfg, params = rg_setup
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5
    y_fast, _ = rg.rglru_block(params, x, cfg)
    np.testing.assert_allclose(y_fast.numpy(), _rglru_sequential(params, x, cfg).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_rglru_chunked_prefill_equals_oneshot(rg_setup):
    cfg, params = rg_setup
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(2)) * 0.5
    y_full, _ = rg.rglru_block(params, x, cfg)
    state = rg.init_rglru_state(cfg, 2)
    y1, state = rg.rglru_block(params, x[:, :7], cfg, state)
    y2, state = rg.rglru_block(params, x[:, 7:], cfg, state)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), y_full.numpy(),
                               rtol=2e-4, atol=2e-4)


@settings(max_examples=10, deadline=None)
@given(T=st.integers(2, 24), seed=st.integers(0, 100))
def test_property_rglru_state_streaming(T, seed):
    cfg = get_config("recurrentgemma-2b", smoke=True)
    params = rg.init_rglru_block(ParamBuilder(torch.Generator().manual_seed(3)), cfg)
    x = torch.randn((1, T, cfg.d_model), generator=torch.Generator().manual_seed(seed)) * 0.3
    y_full, _ = rg.rglru_block(params, x, cfg)
    state = rg.init_rglru_state(cfg, 1)
    ys = []
    for t in range(T):  # token-by-token decode
        y_t, state = rg.rglru_block(params, x[:, t:t + 1], cfg, state)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_full.numpy(),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("cell,init_state", [
    (xl.mlstm, xl.init_mlstm_state),
    (xl.slstm, xl.init_slstm_state),
])
def test_xlstm_streaming_matches_full(cell, init_state):
    cfg = get_config("xlstm-350m", smoke=True)
    init_fn = xl.init_mlstm if cell is xl.mlstm else xl.init_slstm
    params = init_fn(ParamBuilder(torch.Generator().manual_seed(4)), cfg)
    T = 10
    x = torch.randn((2, T, cfg.d_model), generator=torch.Generator().manual_seed(5)) * 0.5
    y_full, _ = cell(params, x, cfg, init_state(cfg, 2))
    state = init_state(cfg, 2)
    ys = []
    for t in range(T):
        y_t, state = cell(params, x[:, t:t + 1], cfg, state)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_mlstm_state_shape_constant_in_T():
    cfg = get_config("xlstm-350m", smoke=True)
    s = xl.init_mlstm_state(cfg, 4)
    bytes_ = sum(x.numel() * x.element_size() for x in s.values())
    # matrix state (B,H,dh,dh)+(B,H,dh)+(B,H): independent of any seq length
    assert bytes_ < 4 * cfg.n_heads * (64 ** 2 + 64 + 1) * 4 * 4


# --- the port against the reference ----------------------------------------------

@pytest.fixture(scope="module")
def rg_pair():
    cfg_j = get_config_jax("recurrentgemma-2b", smoke=True)
    cfg = get_config("recurrentgemma-2b", smoke=True)
    params = _ref_params(rg_jax.init_rglru_block, cfg_j, 7)
    return cfg_j, cfg, params, jax.jit(rg_jax.rglru_block, static_argnums=(2,))


def test_rglru_block_matches_reference_oneshot_chunked_and_stepwise(rg_pair):
    cfg_j, cfg, params, block_j = rg_pair
    pt = _t(params)
    x = _x(8, (2, 19, cfg.d_model), 0.5)
    yj, sj = block_j(params, jnp.asarray(x), cfg_j)
    yt, st_ = rg.rglru_block(pt, torch.as_tensor(x), cfg)
    _close(yt, yj)
    _close(st_["h"], sj["h"])
    _close(st_["conv"], sj["conv"])
    # chunked with a carried state
    sj = rg_jax.init_rglru_state(cfg_j, 2)
    sp = rg.init_rglru_state(cfg, 2)
    for lo, hi in ((0, 7), (7, 8), (8, 19)):
        yj, sj = block_j(params, jnp.asarray(x[:, lo:hi]), cfg_j, sj)
        yt, sp = rg.rglru_block(pt, torch.as_tensor(x[:, lo:hi]), cfg, sp)
        _close(yt, yj)
        _close(sp["h"], sj["h"])
        _close(sp["conv"], sj["conv"])
    # token by token from the start
    sj, sp = rg_jax.init_rglru_state(cfg_j, 2), rg.init_rglru_state(cfg, 2)
    for t in range(6):
        yj, sj = block_j(params, jnp.asarray(x[:, t:t + 1]), cfg_j, sj)
        yt, sp = rg.rglru_block(pt, torch.as_tensor(x[:, t:t + 1]), cfg, sp)
        _close(yt, yj)
        _close(sp["h"], sj["h"])


@pytest.mark.parametrize("T", [1, 2, 12, 257, 1024])
def test_associative_scan_matches_lax_associative_scan(T):
    """The scan alone against ``jax.lax.associative_scan`` on the same
    combine, at the pair counts of a decode step, a prefill and a long
    prompt, each relative to max |h|."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (2, T, 48)).astype(np.float32)
    b = rng.standard_normal((2, T, 48)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    ha, hb = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1))(a, b)
    ta, tb = rg.associative_scan(torch.as_tensor(a), torch.as_tensor(b))
    scale = float(np.abs(np.asarray(hb)).max())
    np.testing.assert_allclose(tb.numpy(), np.asarray(hb), rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ha), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_cells_match_reference_full_and_streaming(kind):
    cfg_j = get_config_jax("xlstm-350m", smoke=True)
    cfg = get_config("xlstm-350m", smoke=True)
    init_j = xl_jax.init_mlstm if kind == "mlstm" else xl_jax.init_slstm
    state_j = xl_jax.init_mlstm_state if kind == "mlstm" else xl_jax.init_slstm_state
    state_p = xl.init_mlstm_state if kind == "mlstm" else xl.init_slstm_state
    cell_j = jax.jit(getattr(xl_jax, kind), static_argnums=(2,))
    cell_p = getattr(xl, kind)
    params = _ref_params(init_j, cfg_j, 9)
    pt = _t(params)
    x = _x(10, (2, 11, cfg.d_model), 0.5)
    yj, sj = cell_j(params, jnp.asarray(x), cfg_j)                  # no state given
    yt, sp = cell_p(pt, torch.as_tensor(x), cfg)
    _close(yt, yj)
    assert sp.keys() == sj.keys()
    for key in sj:
        _close(sp[key], sj[key])
    # streaming: 4 tokens, then one, then the rest
    sj, sp = state_j(cfg_j, 2), state_p(cfg, 2)
    for lo, hi in ((0, 4), (4, 5), (5, 11)):
        yj, sj = cell_j(params, jnp.asarray(x[:, lo:hi]), cfg_j, sj)
        yt, sp = cell_p(pt, torch.as_tensor(x[:, lo:hi]), cfg, sp)
        _close(yt, yj)
        for key in sj:
            _close(sp[key], sj[key])


def test_recurrent_init_matches_reference_constants_and_shapes():
    """The port's own init: every leaf of the reference's shape and dtype,
    RG-LRU's Lambda and mLSTM's gate bias the reference's constants."""
    for arch, inits in (("recurrentgemma-2b", [(rg_jax.init_rglru_block, rg.init_rglru_block)]),
                        ("xlstm-350m", [(xl_jax.init_mlstm, xl.init_mlstm),
                                        (xl_jax.init_slstm, xl.init_slstm)])):
        cfg_j, cfg = get_config_jax(arch, smoke=True), get_config(arch, smoke=True)
        for init_j, init_p in inits:
            ref = _ref_params(init_j, cfg_j, 0)
            ours = init_p(ParamBuilder(torch.Generator().manual_seed(0)), cfg)
            assert ours.keys() == ref.keys()
            for key, val in ref.items():
                assert tuple(ours[key].shape) == val.shape and ours[key].dtype == torch.float32
    lam_j = _ref_params(rg_jax.init_rglru_block, get_config_jax("recurrentgemma-2b"), 0)["lam"]
    lam_p = rg.init_rglru_block(ParamBuilder(torch.Generator().manual_seed(0)),
                                get_config("recurrentgemma-2b"))["lam"]
    np.testing.assert_allclose(lam_p.numpy(), lam_j, rtol=1e-5, atol=0)
    b_if = xl.init_mlstm(ParamBuilder(torch.Generator()), get_config("xlstm-350m", smoke=True))
    np.testing.assert_array_equal(
        b_if["b_if"].numpy(), _ref_params(xl_jax.init_mlstm, cfg_j, 0)["b_if"])
