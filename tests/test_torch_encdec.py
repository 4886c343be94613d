"""Port parity for whisper's encoder-decoder (``repro_torch.models.encdec``,
``attention.cross_attention`` and the enc-dec ``Model``) on the CPU, where
every attention takes K4's plain version: against the jitted reference on
the reference's weights (``interop.encdec_params_from_numpy``), at TOL =
2e-5 (the same fp32 arithmetic, products summed in another order):
``sinusoidal_positions``, ``cross_attention`` with and without precomputed
K/V, ``encode``, ``compute_cross_kv``, ``decode`` with and without
``cross_kv``, and the model's forward, loss, prefill and teacher-forced
decode through the KV cache.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import attention as attn_jax
from repro.models import build_model as build_jax
from repro.models import common as common_jax
from repro.models import encdec as encdec_jax
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import attention as attn_pt
from repro_torch.models import build_model
from repro_torch.models import common as common_pt
from repro_torch.models import encdec

TOL = 2e-5
ARCH = "whisper-large-v3"


def _close(out_t, ref_j, tol=TOL):
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(ref_j), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def whisper():
    """The reference's smoke model with nonzero biases (so their layout is
    exercised), the port's on the same weights, frames and tokens."""
    cfg_j, cfg = get_config_jax(ARCH, smoke=True), get_config(ARCH, smoke=True)
    model_j = build_jax(cfg_j)
    params_j, _ = model_j.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params_j = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                         if path[-1].key in ("bq", "bk", "bv", "bo") else v), params_j)
    params_np = jax.tree.map(np.asarray, params_j)
    params = interop.encdec_params_from_numpy(cfg, params_np, device="cpu")
    frames = (rng.standard_normal((2, cfg.enc_frames, cfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    return cfg_j, cfg, model_j, params_j, build_model(cfg), params, frames, toks


def test_sinusoidal_positions_match_reference():
    """At the smoke sizes within 1e-6.  At whisper's (1500, 1280) the two
    libraries' exp may round a frequency an ulp apart, which moves the
    angle at position 1499 by an ulp of 1499 (2^-13 = 1.22e-4), and its
    sin and cos by as much: held to that one ulp."""
    for t, d in ((16, 64), (7, 10)):
        _close(common_pt.sinusoidal_positions(t, d), common_jax.sinusoidal_positions(t, d), 1e-6)
    np.testing.assert_allclose(common_pt.sinusoidal_positions(1500, 1280).numpy(),
                               np.asarray(common_jax.sinusoidal_positions(1500, 1280)),
                               rtol=0, atol=2.0 ** -13)


def test_interop_unstacks_the_reference_tree(whisper):
    cfg_j, cfg, _, params_j, _, params, _, _ = whisper
    assert len(params["encoder"]) == cfg.n_enc_layers and len(params["decoder"]) == cfg.n_layers
    np.testing.assert_array_equal(params["decoder"][1]["cross_attn"]["wk"].numpy(),
                                  np.asarray(params_j["decoder"]["cross_attn"]["wk"][1]))
    assert params["encoder"][0].keys() == {"norm1", "attn", "norm2", "mlp"}
    # lm_params_from_numpy sends an enc-dec config to the same conversion
    same = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params_j), device="cpu")
    assert torch.equal(same["encoder"][1]["mlp"]["w_up"], params["encoder"][1]["mlp"]["w_up"])


def test_encode_cross_kv_and_cross_attention_match_reference(whisper):
    cfg_j, cfg, _, params_j, _, params, frames, _ = whisper
    enc_j = jax.jit(encdec_jax.encode, static_argnums=(2,))(params_j, jnp.asarray(frames), cfg_j)
    enc = encdec.encode(params, torch.as_tensor(frames), cfg)
    _close(enc, enc_j)
    kv_j = jax.jit(encdec_jax.compute_cross_kv, static_argnums=(2,))(params_j, enc_j, cfg_j)
    kv = encdec.compute_cross_kv(params, enc, cfg)
    assert len(kv) == cfg.n_layers
    for i, layer in enumerate(kv):
        _close(layer["k"], kv_j["k"][i])
        _close(layer["v"], kv_j["v"][i])
    # one layer's cross-attention, projecting the encoder output or not
    x = np.random.default_rng(1).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda a: a[1], params_j["decoder"])["cross_attn"]
    p = params["decoder"][1]["cross_attn"]
    ref = attn_jax.cross_attention(p_j, jnp.asarray(x), enc_j, cfg_j)
    _close(attn_pt.cross_attention(p, torch.as_tensor(x), enc, cfg), ref)
    _close(attn_pt.cross_attention(p, torch.as_tensor(x), None, cfg, kv=kv[1]), ref)


@pytest.mark.parametrize("with_cross_kv", [False, True])
def test_decode_matches_reference(whisper, with_cross_kv):
    """``decode`` projecting the encoder output in every layer, and with the
    precomputed ``cross_kv`` through a KV cache (the reference's decode
    takes ``cross_kv`` only with caches)."""
    cfg_j, cfg, _, params_j, _, params, frames, toks = whisper
    enc_j = encdec_jax.encode(params_j, jnp.asarray(frames), cfg_j)
    enc = encdec.encode(params, torch.as_tensor(frames), cfg)
    if not with_cross_kv:
        lj, _ = encdec_jax.decode(params_j, jnp.asarray(toks), enc_j, cfg_j)
        lp, none = encdec.decode(params, torch.as_tensor(toks), enc, cfg)
        assert none is None and lp.dtype == torch.float32
        _close(lp, lj)
        return
    kv_j = encdec_jax.compute_cross_kv(params_j, enc_j, cfg_j)
    kv = encdec.compute_cross_kv(params, enc, cfg)
    cj = encdec_jax.init_dec_caches(cfg_j, 2, 16, jnp.float32)
    cp = encdec.init_dec_caches(cfg, 2, 16, torch.float32)
    lj, cj = encdec_jax.decode(params_j, jnp.asarray(toks), None, cfg_j, cj, cross_kv=kv_j)
    lp, cp = encdec.decode(params, torch.as_tensor(toks), None, cfg, cp, cross_kv=kv)
    _close(lp, lj)
    for i, c in enumerate(cp):
        assert c["pos"] == int(cj["pos"][i]) == toks.shape[1]
        _close(c["k"], cj["k"][i])
    # without a cache the port takes cross_kv too, with the same logits
    lp2, _ = encdec.decode(params, torch.as_tensor(toks), None, cfg, cross_kv=kv)
    _close(lp2, lj)


def test_encdec_model_matches_reference(whisper):
    """The forward, the loss, and a prefill then teacher-forced decode
    through the KV cache, logits compared at every step."""
    cfg_j, cfg, model_j, params_j, model, params, frames, toks = whisper
    model_j = dataclasses.replace(model_j, forward=jax.jit(model_j.forward),
                                  prefill=jax.jit(model_j.prefill),
                                  decode_step=jax.jit(model_j.decode_step))
    ft, fe = torch.as_tensor(toks), torch.as_tensor(frames)
    _close(model.forward(params, ft, fe), model_j.forward(params_j, jnp.asarray(toks),
                                                          jnp.asarray(frames)))
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
               "embeds": jnp.asarray(frames)}
    _close(model.loss_fn(params, {"tokens": ft, "labels": ft, "embeds": fe}),
           model_j.loss_fn(params_j, batch_j))
    P, max_len = 5, 16
    cache_j = model_j.init_cache(2, max_len)
    cache = model.init_cache(2, max_len, device="cpu")
    assert cache["cross_kv"] is None and len(cache["dec"]) == cfg.n_layers
    lj, cache_j = model_j.prefill(params_j, jnp.asarray(toks[:, :P]), cache_j, jnp.asarray(frames))
    lp, cache = model.prefill(params, ft[:, :P], cache, fe)
    assert lp.shape == (2, cfg.vocab)
    _close(lp, lj)
    _close(cache["cross_kv"][0]["k"], cache_j["cross_kv"]["k"][0])
    for t in range(P, toks.shape[1]):
        lj, cache_j = model_j.decode_step(params_j, jnp.asarray(toks[:, t:t + 1]), cache_j)
        lp, cache = model.decode_step(params, ft[:, t:t + 1], cache)
        _close(lp, lj)
    assert all(c["pos"] == toks.shape[1] for c in cache["dec"])
