"""The other model families in the port (recurrentgemma's RG-LRU hybrid,
xLSTM, the two MoE models and whisper's encoder-decoder) on the CPU, where
attention takes K4's plain version.

First ``tests/test_models_smoke.py``'s cases for these five archs against
the port: forward shapes and finiteness, one training gradient (finite, CE
near log V, the embedding reached), prefill then decode against the
forward at the reference's 5e-3, and the recurrent state's size O(1) in the
sequence length.  Then the port against the jitted reference on the
reference's weights (``interop.lm_params_from_numpy``): whole-model logits
of the forward, the prefill and teacher-forced decode at TOL = 2e-5 (the
same fp32 arithmetic, products summed in another order, over 2-6 layers),
the loss's gradient against ``jax.grad`` within 1e-4 of each leaf's max
|.| (the port's training parity tolerance, tests/test_torch_train.py;
a leaf whose gradient is zero in exact arithmetic, below 1e-6 of the
largest, must stay below that on both sides),
``tests/test_ring_cache.py``'s two tests on recurrentgemma, and the
port's own init against the reference's distributions (every leaf's shape
and dtype, constants equal, normal leaves' moments within five standard
errors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import build_model as build_jax
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves

FAMILIES = ["recurrentgemma-2b", "xlstm-350m", "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
            "whisper-large-v3"]
TOL = 2e-5
GRAD_TOL = 1e-4
NOISE = 1e-6  # a leaf's gradient below this share of the largest is rounding noise


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed, B=2, T=16):
    """Tokens and, for whisper, stub frames, as numpy (the smoke test's
    shapes: (B, T) tokens, (B, enc_frames, d) frames x 0.02)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    emb = None
    if cfg.frontend == "audio_stub":
        emb = (rng.standard_normal((B, cfg.enc_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, emb


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(out_t, ref_j, tol=TOL):
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(ref_j), rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """The reference's smoke model (jitted) and weights, and the port's
    model on those weights."""
    arch = request.param
    cfg_j, cfg = get_config_jax(arch, smoke=True), get_config(arch, smoke=True)
    model_j = build_jax(cfg_j)
    params_j, _ = model_j.init(jax.random.PRNGKey(0))
    model_j = dataclasses.replace(model_j, forward=jax.jit(model_j.forward),
                                  prefill=jax.jit(model_j.prefill),
                                  decode_step=jax.jit(model_j.decode_step))
    params = interop.lm_params_from_numpy(cfg, _np(params_j), device="cpu")
    return arch, cfg_j, model_j, params_j, cfg, build_model(cfg), params


# --- tests/test_models_smoke.py, against the port -------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_shapes_and_finiteness(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks, emb = _batch(cfg, 1)
    logits = model.forward(params, _t(toks), _t(emb))
    assert logits.shape == (2, toks.shape[1], cfg.vocab), logits.shape
    assert bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits"


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_train_step_no_nans(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks, emb = _batch(cfg, 1)
    loss = model.loss_fn(params, {"tokens": _t(toks), "labels": _t(toks), "embeds": _t(emb)})
    loss.backward()
    loss = loss.detach()
    assert bool(torch.isfinite(loss)), f"{arch}: loss={loss}"
    # CE at init should be near log(vocab)
    assert float(loss) < np.log(cfg.vocab) + 2.0
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in leaves)
    # gradient must actually flow to the embedding
    assert float(params["embed"].grad.abs().max()) > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_then_decode_matches_forward(arch):
    """KV-cache/recurrent-state decode must agree with the full pass."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks, emb = _batch(cfg, 2, T=12)
    full = model.forward(params, _t(toks), _t(emb))
    cache = model.init_cache(2, max_len=64, device="cpu")
    _, cache = model.prefill(params, _t(toks[:, :-1]), cache, _t(emb))
    step, cache = model.decode_step(params, _t(toks[:, -1:]), cache)
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(), rtol=5e-3, atol=5e-3)


def _state_bytes(cache) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache)
               if isinstance(x, torch.Tensor))


@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-2b"])
def test_recurrent_state_is_O1_in_seq(arch):
    """The long_500k applicability rule: state size must not grow with the
    cache length for SSM/hybrid archs (modulo the bounded local window)."""
    model = build_model(get_config(arch, smoke=True))
    b1 = _state_bytes(model.init_cache(1, max_len=64, device="cpu"))
    b2 = _state_bytes(model.init_cache(1, max_len=128, device="cpu"))
    if arch == "xlstm-350m":
        assert b1 == b2, "xLSTM state must be O(1) in sequence length"
    else:
        # hybrid: only the local-attn window cache grows (bounded by window)
        assert b2 <= 2.5 * b1


# --- the port against the reference -----------------------------------------------

def test_logits_forward_prefill_and_cached_decode_match_reference(family):
    """The no-cache forward, then prefill and teacher-forced decode through
    the caches, logits compared at every step (past recurrentgemma's
    window of 8)."""
    arch, cfg_j, model_j, params_j, cfg, model, params = family
    B, T, P, max_len = 2, 14, 5, 16
    toks, emb = _batch(cfg, 3, B=B, T=T)
    _close(model.forward(params, _t(toks), _t(emb)), model_j.forward(params_j, _j(toks), _j(emb)))
    cache_j = model_j.init_cache(B, max_len)
    cache = model.init_cache(B, max_len, device="cpu")
    if emb is None:
        lj, cache_j = model_j.prefill(params_j, _j(toks[:, :P]), cache_j)
    else:
        lj, cache_j = model_j.prefill(params_j, _j(toks[:, :P]), cache_j, _j(emb))
    lp, cache = model.prefill(params, _t(toks[:, :P]), cache, _t(emb))
    assert lp.shape == (B, cfg.vocab) and lp.dtype == torch.float32
    _close(lp, lj)
    for t in range(P, T):
        lj, cache_j = model_j.decode_step(params_j, _j(toks[:, t:t + 1]), cache_j)
        lp, cache = model.decode_step(params, _t(toks[:, t:t + 1]), cache)
        _close(lp, lj)


def test_loss_gradients_match_jax_grad(family):
    arch, cfg_j, model_j, params_j, cfg, model, params = family
    toks, emb = _batch(cfg, 4)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if emb is not None:
        batch["embeds"] = emb
    loss_j, grads_j = jax.jit(jax.value_and_grad(model_j.loss_fn))(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    want = tree_leaves(interop.lm_params_from_numpy(cfg, _np(grads_j), device="cpu"))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss_fn(params, {k: torch.as_tensor(v) for k, v in batch.items()})
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5, atol=0)
        assert len(want) == len(leaves)
        top = max(float(w.abs().max()) for w in want)
        for p, w in zip(leaves, want):
            scale = float(w.abs().max())
            if scale < NOISE * top:
                # zero in exact arithmetic (whisper's key biases without
                # RoPE: a row's softmax ignores a constant added to its
                # scores): rounding noise on both sides
                assert float(p.grad.abs().max()) < NOISE * top
                continue
            np.testing.assert_allclose(p.grad.numpy(), w.numpy(), rtol=0,
                                       atol=GRAD_TOL * scale)
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)


def _run(model, params, toks, n_new, max_len, stepwise_prompt):
    """Greedy decode of ``n_new`` tokens after the prompt (fed token by
    token when ``stepwise_prompt``, the ring cache's way), stacking the
    logits of each step, as tests/test_ring_cache.py's loops do."""
    is_jax = not isinstance(toks, torch.Tensor)
    B, P = toks.shape
    cache = model.init_cache(B, max_len) if is_jax else model.init_cache(B, max_len,
                                                                         device="cpu")
    if stepwise_prompt:
        for t in range(P):
            logits, cache = model.decode_step(params, toks[:, t:t + 1], cache)
    else:
        logits, cache = model.prefill(params, toks, cache)
    outs = [logits]
    for _ in range(n_new):
        cur = (jnp.argmax(logits, -1)[:, None].astype(jnp.int32) if is_jax
               else torch.argmax(logits, -1)[:, None].to(torch.int32))
        logits, cache = model.decode_step(params, cur, cache)
        outs.append(logits)
    return np.stack([np.asarray(o) for o in outs])


def test_ring_cache_matches_full_cache():
    """Ring-buffer local attention decodes as the full-context cache does
    (test_ring_cache.py's tolerance, 2e-4), and the port's ring run equals
    the reference's at TOL, well past the window of 8."""
    cfg_j, cfg = get_config_jax("recurrentgemma-2b", smoke=True), get_config(
        "recurrentgemma-2b", smoke=True)
    ring_j = build_jax(cfg_j, ring_local=True)
    ring_j = dataclasses.replace(ring_j, decode_step=jax.jit(ring_j.decode_step))
    params_j, _ = ring_j.init(jax.random.PRNGKey(0))
    params = interop.lm_params_from_numpy(cfg, _np(params_j), device="cpu")
    full, ring = build_model(cfg), build_model(cfg, ring_local=True)
    B, T_prompt, n_new = 2, 4, 14
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(B, T_prompt)).astype(np.int32)
    max_len = T_prompt + n_new + 2
    out_full = _run(full, params, torch.as_tensor(toks), n_new, max_len, True)
    out_ring = _run(ring, params, torch.as_tensor(toks), n_new, max_len, True)
    out_ring_j = _run(ring_j, params_j, jnp.asarray(toks), n_new, max_len, True)
    np.testing.assert_allclose(out_ring, out_full, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out_ring, out_ring_j, rtol=TOL, atol=TOL)


def test_ring_cache_is_window_sized():
    cfg_j, cfg = get_config_jax("recurrentgemma-2b", smoke=True), get_config(
        "recurrentgemma-2b", smoke=True)
    big = 4096
    b_ring = _state_bytes(build_model(cfg, ring_local=True).init_cache(1, big, device="cpu"))
    b_full = _state_bytes(build_model(cfg).init_cache(1, big, device="cpu"))
    assert b_ring < b_full / 50, (b_ring, b_full)

    def ref_bytes(model):  # its tensors, without the per-layer pos/ring scalars
        return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(model.init_cache(1, big))
                   if x.ndim >= 3)

    assert (b_ring, b_full) == (ref_bytes(build_jax(cfg_j, ring_local=True)),
                                ref_bytes(build_jax(cfg_j)))


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_moments_match_reference(arch):
    """The port's own init draws the reference's distributions: per leaf the
    same shape and dtype, constants equal, and the normal leaves' mean and
    standard deviation within five standard errors of the reference's."""
    cfg_j, cfg = get_config_jax(arch, smoke=True), get_config(arch, smoke=True)
    params_j, _ = build_jax(cfg_j).init(jax.random.PRNGKey(6))
    ref = interop.lm_params_from_numpy(cfg, _np(params_j), device="cpu")
    ours = build_model(cfg).init(6, device="cpu")
    got, want = dict(_paths(ours)), dict(_paths(ref))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.numel() == 1 or float(w.std()) == 0.0 or path.endswith(("/lam", "/b_if")):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=0, err_msg=path)
            continue
        n, sd = w.numel(), float(w.std())
        assert abs(float(g.mean()) - float(w.mean())) <= 5 * sd * (2.0 / n) ** 0.5, path
        assert abs(float(g.std()) - sd) <= 5 * sd * (1.0 / n) ** 0.5, path


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-large-v3"])
def test_serve_engine_generates_as_the_reference(arch):
    """``ServeEngine.generate`` against the reference's engine on the same
    weights: the same greedy tokens (whisper from stub frames, through
    ``embeds=``)."""
    from repro.runtime.serve_loop import ServeEngine as ServeEngineJax
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg_j, cfg = get_config_jax(arch, smoke=True), get_config(arch, smoke=True)
    model_j = build_jax(cfg_j)
    params_j, _ = model_j.init(jax.random.PRNGKey(8))
    params = interop.lm_params_from_numpy(cfg, _np(params_j), device="cpu")
    toks, emb = _batch(cfg, 8, B=3, T=7)
    out_j = ServeEngineJax(model_j, params_j, max_len=24).generate(toks, n_new=6, embeds=emb)
    out = ServeEngine(build_model(cfg), params, max_len=24, device="cpu").generate(
        toks, n_new=6, embeds=emb)
    assert out.shape == (3, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, out_j)


def test_launch_serve_takes_every_decoder_family_and_refuses_enc_dec():
    """``launch/serve --arch`` serves the recurrent and MoE families; an
    encoder-decoder arch raises ``ValueError`` (it needs frames; the
    reference's launcher fails there too)."""
    from repro_torch.launch import serve

    for arch in FAMILIES[:-1]:
        out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "1",
                          "--batch", "2", "--prompt-len", "5", "--new-tokens", "2",
                          "--max-len", "8"])
        assert len(out) == 1 and out[0].shape == (2, 2), arch
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--arch", "whisper-large-v3", "--smoke", "--device", "cpu"])
