"""Port parity for the LM stack (``repro_torch.models``): the common ops, the
MLP, the attention block (no cache, KV cache, ring cache) and the whole
decoder-only model against the JAX reference on the same numpy inputs and
the reference's own weights (``interop.lm_params_from_numpy``), on the CPU,
where attention takes K4's plain version.  Also the copied configs, the
parameter counts, the init distributions, and every arch of the registry
building and running (the other families' parity is in
tests/test_torch_recurrent.py, test_torch_moe.py, test_torch_encdec.py and
test_torch_families.py).

Tolerances: the element-wise ops and RoPE rtol/atol 1e-6 (the same fp32
formula; transcendental functions of two libraries differ by an ulp or
two); the MLP, the attention block and the models rtol/atol 2e-5, the
reference's float32 attention tolerance (the same fp32 arithmetic, matrix
products summed in another order by another library, over d_model <= 64
and 2-4 layers); the init moments within five standard errors of the
sample statistics (the two generators draw different numbers from the same
distributions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as ARCH_IDS_JAX
from repro.configs import get_config as get_config_jax
from repro.models import attention as attn_jax
from repro.models import build_model as build_jax
from repro.models import common as common_jax
from repro.models import mlp as mlp_jax
from repro.models.config import ModelConfig as ModelConfigJax
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, REGISTRY, get_config
from repro_torch.models import attention as attn_pt
from repro_torch.models import build_model
from repro_torch.models import common as common_pt
from repro_torch.models import mlp as mlp_pt
from repro_torch.models.config import ModelConfig

TOL = 2e-5
SERVED = ["phi4-mini-3.8b", "mistral-nemo-12b", "granite-20b", "gemma2-27b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _close(out_t, ref_j, tol=TOL):
    np.testing.assert_allclose(out_t.detach().float().numpy(), np.asarray(ref_j, np.float32),
                               rtol=tol, atol=tol)


def _jitted(model):
    """The reference's model functions under ``jax.jit``, as its serving
    engine runs them (one compile per shape instead of one per primitive)."""
    return dataclasses.replace(model, forward=jax.jit(model.forward),
                               prefill=jax.jit(model.prefill),
                               decode_step=jax.jit(model.decode_step))


def _pair_cfg(**kw):
    return ModelConfigJax(**kw), ModelConfig(**kw)


# --- configs ------------------------------------------------------------------

def test_configs_equal_reference():
    assert ARCH_IDS == ARCH_IDS_JAX and set(REGISTRY) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        for smoke in (False, True):
            ours, ref = get_config(arch, smoke=smoke), get_config_jax(arch, smoke=smoke)
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref), arch
            assert ours.n_params() == ref.n_params(), arch
            assert ours.n_active_params() == ref.n_active_params(), arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")
    assert get_config("phi4-mini-3.8b", n_layers=2).n_layers == 2
    # phi4-mini-3.8b at full size: about 3.84 B parameters.
    assert round(get_config("phi4-mini-3.8b").n_params() / 1e9, 2) == 3.84


# --- common ops ---------------------------------------------------------------

def test_common_ops_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    s = rng.standard_normal(24).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    xt, st, bt = map(torch.as_tensor, (x, s, b))
    for plus_one in (False, True):
        _close(common_pt.rms_norm(xt, st, scale_plus_one=plus_one),
               common_jax.rms_norm(jnp.asarray(x), jnp.asarray(s), scale_plus_one=plus_one), 1e-6)
    for bias in (None, b):
        _close(common_pt.layer_norm(xt, st, None if bias is None else bt),
               common_jax.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                     None if bias is None else jnp.asarray(bias)), 1e-6)
    _close(common_pt.softcap(xt, 5.0), common_jax.softcap(jnp.asarray(x), 5.0), 1e-6)
    assert common_pt.softcap(xt, None) is xt
    for name in ("silu", "gelu", "relu", "tanh"):
        _close(common_pt.ACT[name](xt), common_jax.ACT[name](jnp.asarray(x)), 1e-6)
    for hd, theta in ((8, 10000.0), (128, 10000.0), (16, 5e6)):
        _close(common_pt.rope_freqs(hd, theta), common_jax.rope_freqs(hd, theta), 1e-6)
    h = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [40, 41, 42, 43, 44, 45, 46]], np.int32)
    _close(common_pt.apply_rope(torch.as_tensor(h), torch.as_tensor(pos)),
           common_jax.apply_rope(jnp.asarray(h), jnp.asarray(pos)), 1e-5)
    _close(common_pt.apply_rope(torch.as_tensor(h), torch.as_tensor(pos[1]), 5e5),
           common_jax.apply_rope(jnp.asarray(h), jnp.asarray(pos[1]), 5e5), 1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    cj, cp = _pair_cfg(name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                       d_ff=96, vocab=16, mlp=kind)
    params = _np(common_jax.unzip_params(
        mlp_jax.init_mlp(common_jax.ParamBuilder(jax.random.PRNGKey(1)), cj))[0])
    x = np.random.default_rng(1).standard_normal((2, 6, 32)).astype(np.float32)
    _close(mlp_pt.mlp(_t(params), torch.as_tensor(x), cp),
           mlp_jax.mlp(params, jnp.asarray(x), cj))


# --- the attention block ----------------------------------------------------------

@pytest.mark.parametrize("bias,local,softcap", [(False, False, None), (True, True, 50.0)])
def test_attention_block_matches_reference(bias, local, softcap):
    """No cache; a KV cache (prefill 6 tokens, one decode step, then 3 more
    tokens); and the ring cache of a local layer decoding past its window."""
    attention_j = jax.jit(attn_jax.attention, static_argnums=(2,), static_argnames=("local",))
    cj, cp = _pair_cfg(name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                       head_dim=8, d_ff=64, vocab=16, window=4, attn_bias=bias,
                       attn_softcap=softcap)
    params = _np(common_jax.unzip_params(
        attn_jax.init_attention(common_jax.ParamBuilder(jax.random.PRNGKey(2)), cj))[0])
    if bias:  # nonzero biases, so their layout is exercised
        rng = np.random.default_rng(9)
        params = {k: (rng.standard_normal(v.shape).astype(np.float32) if k[0] == "b" else v)
                  for k, v in params.items()}
    pt = _t(params)
    x = np.random.default_rng(2).standard_normal((2, 10, 32)).astype(np.float32)
    yj, _ = attention_j(params, jnp.asarray(x), cj, local=local)
    yt, none = attn_pt.attention(pt, torch.as_tensor(x), cp, local=local)
    assert none is None
    _close(yt, yj)

    cj_cache = attn_jax.init_cache(cj, 2, 16, jnp.float32)
    cp_cache = attn_pt.init_cache(cp, 2, 16, torch.float32)
    for lo, hi in [(0, 6), (6, 7), (7, 10)]:
        yj, cj_cache = attention_j(params, jnp.asarray(x[:, lo:hi]), cj, local=local,
                                          cache=cj_cache)
        yt, cp_cache = attn_pt.attention(pt, torch.as_tensor(x[:, lo:hi]), cp, local=local,
                                         cache=cp_cache)
        assert cp_cache["pos"] == int(cj_cache["pos"]) == hi
        _close(yt, yj)
    _close(cp_cache["k"][:, :, :10], np.asarray(cj_cache["k"])[:, :, :10])

    # Ring buffer of `window` slots, token by token from the start.
    rj = dict(attn_jax.init_cache(cj, 2, cj.window, jnp.float32), ring=jnp.ones((), jnp.int32))
    rp = dict(attn_pt.init_cache(cp, 2, cp.window, torch.float32), ring=True)
    for t in range(6):
        yj, rj = attention_j(params, jnp.asarray(x[:, t:t + 1]), cj, local=True, cache=rj)
        yt, rp = attn_pt.attention(pt, torch.as_tensor(x[:, t:t + 1]), cp, local=True, cache=rp)
        _close(yt, yj)
    with pytest.raises(ValueError, match="decode"):
        attn_pt.attention(pt, torch.as_tensor(x[:, :2]), cp, local=True, cache=rp)
    # Cross-attention (whisper's decoder) of 3 queries over these 10 states.
    xq = np.random.default_rng(3).standard_normal((2, 3, 32)).astype(np.float32)
    _close(attn_pt.cross_attention(pt, torch.as_tensor(xq), torch.as_tensor(x), cp),
           attn_jax.cross_attention(params, jnp.asarray(xq), jnp.asarray(x), cj))


# --- whole models -------------------------------------------------------------

def _cfgs(arch):
    """The smoke config of ``arch`` in the reference and in the port."""
    return get_config_jax(arch, smoke=True), get_config(arch, smoke=True)

@pytest.fixture(scope="module", params=SERVED)
def served(request):
    """A reference model, its weights, and the port's model on those weights."""
    arch = request.param
    cfg_j, cfg_p = get_config_jax(arch, smoke=True), get_config(arch, smoke=True)
    model_j = _jitted(build_jax(cfg_j))
    params_j, _ = model_j.init(jax.random.PRNGKey(0))
    params_p = interop.lm_params_from_numpy(cfg_p, _np(params_j), device="cpu")
    return arch, cfg_j, model_j, params_j, build_model(cfg_p), params_p


def test_lm_forward_and_cached_decode_match_reference(served):
    """The no-cache forward, then prefill and teacher-forced decode through
    the KV cache, logits compared at every step."""
    arch, cfg, model_j, params_j, model_p, params_p = served
    B, T, P, max_len = 2, 12, 5, 16
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    _close(model_p.forward(params_p, torch.as_tensor(toks)),
           model_j.forward(params_j, jnp.asarray(toks)))

    cache_j = model_j.init_cache(B, max_len)
    cache_p = model_p.init_cache(B, max_len, device="cpu")
    lj, cache_j = model_j.prefill(params_j, jnp.asarray(toks[:, :P]), cache_j)
    lp, cache_p = model_p.prefill(params_p, torch.as_tensor(toks[:, :P]), cache_p)
    assert lp.shape == (B, cfg.vocab) and lp.dtype == torch.float32
    _close(lp, lj)
    for t in range(P, T):
        lj, cache_j = model_j.decode_step(params_j, jnp.asarray(toks[:, t:t + 1]), cache_j)
        lp, cache_p = model_p.decode_step(params_p, torch.as_tensor(toks[:, t:t + 1]), cache_p)
        _close(lp, lj)
    assert all(c["pos"] == T for c in cache_p)


def test_gemma2_ring_cache_decode_matches_reference():
    """gemma2's local layers on a ring buffer of `window` (8) slots, decoding
    token by token past the window, against the reference's ring cache."""
    cfg_j, cfg_p = _cfgs("gemma2-27b")
    model_j = _jitted(build_jax(cfg_j, ring_local=True))
    params_j, _ = model_j.init(jax.random.PRNGKey(4))
    model_p = build_model(cfg_p, ring_local=True)
    params_p = interop.lm_params_from_numpy(cfg_p, _np(params_j), device="cpu")
    B, T, max_len = 2, 11, 16
    toks = np.random.default_rng(4).integers(0, cfg_j.vocab, size=(B, T)).astype(np.int32)
    cache_j, cache_p = model_j.init_cache(B, max_len), model_p.init_cache(B, max_len, device="cpu")
    assert [c["k"].shape[2] for c in cache_p] == [8, 16, 8, 16]
    for t in range(T):
        lj, cache_j = model_j.decode_step(params_j, jnp.asarray(toks[:, t:t + 1]), cache_j)
        lp, cache_p = model_p.decode_step(params_p, torch.as_tensor(toks[:, t:t + 1]), cache_p)
        _close(lp, lj)


def test_llava_embeds_prefix_matches_reference():
    """The vision stub's precomputed patch embeddings ahead of the tokens,
    through the forward, the loss and a prefill."""
    cfg_j, cfg_p = _cfgs("llava-next-34b")
    model_j, model_p = _jitted(build_jax(cfg_j)), build_model(cfg_p)
    params_j, _ = model_j.init(jax.random.PRNGKey(5))
    params_p = interop.lm_params_from_numpy(cfg_p, _np(params_j), device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg_j.vocab, size=(2, 6)).astype(np.int32)
    emb = rng.standard_normal((2, cfg_j.n_patches, cfg_j.d_model)).astype(np.float32)
    lj = model_j.forward(params_j, jnp.asarray(toks), jnp.asarray(emb))
    lp = model_p.forward(params_p, torch.as_tensor(toks), torch.as_tensor(emb))
    assert lp.shape == (2, cfg_j.n_patches + 6, cfg_j.vocab)
    _close(lp, lj)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks), "embeds": jnp.asarray(emb)}
    batch_p = {k: torch.tensor(np.asarray(v)) for k, v in batch_j.items()}
    _close(model_p.loss_fn(params_p, batch_p), model_j.loss_fn(params_j, batch_j))
    cj, cp = model_j.init_cache(2, 32), model_p.init_cache(2, 32, device="cpu")
    lj, _ = model_j.prefill(params_j, jnp.asarray(toks), cj, jnp.asarray(emb))
    lp, _ = model_p.prefill(params_p, torch.as_tensor(toks), cp, torch.as_tensor(emb))
    _close(lp, lj)


def test_init_moments_match_reference():
    """The port's own init draws the reference's distributions: per leaf the
    same shape and dtype, constants equal, and the normal leaves' mean and
    standard deviation within five standard errors of the reference's."""
    cfg_j, cfg_p = _cfgs("mistral-nemo-12b")
    params_j, _ = build_jax(cfg_j).init(jax.random.PRNGKey(6))
    ref = interop.lm_params_from_numpy(cfg_p, _np(params_j), device="cpu")
    ours = build_model(cfg_p).init(6, device="cpu")

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    got, want = dict(leaves(ours)), dict(leaves(ref))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if float(w.std()) == 0.0:
            assert torch.equal(g, w), path
            continue
        n, sd = w.numel(), float(w.std())
        assert abs(float(g.mean()) - float(w.mean())) <= 5 * sd * (2.0 / n) ** 0.5, path
        assert abs(float(g.std()) - sd) <= 5 * sd * (1.0 / n) ** 0.5, path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_and_runs(arch):
    """Every arch of the registry builds in the port and runs its forward,
    loss, prefill and decode step at its smoke config, with finite logits
    of the reference's shapes."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 6)).astype(np.int32))
    emb = None
    if cfg.frontend == "audio_stub":
        emb = torch.as_tensor(rng.standard_normal((2, cfg.enc_frames, cfg.d_model)) * 0.02,
                              dtype=torch.float32)
    prefix = 0 if emb is None or cfg.enc_dec else emb.shape[1]
    logits = model.forward(params, toks, emb)
    assert logits.shape == (2, prefix + 6, cfg.vocab) and bool(torch.isfinite(logits).all())
    loss = model.loss_fn(params, {"tokens": toks, "labels": toks, "embeds": emb})
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    cache = model.init_cache(2, 16, device="cpu")
    last, cache = model.prefill(params, toks[:, :-1], cache, emb)
    step, cache = model.decode_step(params, toks[:, -1:], cache)
    assert last.shape == step.shape == (2, cfg.vocab) and bool(torch.isfinite(step).all())
