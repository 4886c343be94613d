"""Port parity for the serving path (``repro_torch.runtime.serve_loop``,
``repro_torch.core.scheduler``, ``repro_torch.launch.serve``) against the
JAX reference on the CPU, where attention takes K4's plain version.

Generated tokens are compared exactly (greedy argmax over logits that agree
to 2e-5, tests/test_torch_models.py); the scheduler's allocations exactly
and its float32 estimates to 1e-6 relative (the same float32 arithmetic
through the port's ``core.ccp``, tests/test_torch_ccp.py).
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.core.scheduler import CCPScheduler as CCPSchedulerJax
from repro.models import attention as attn_jax
from repro.models import build_model as build_jax
from repro.runtime.serve_loop import ServeEngine as ServeEngineJax
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.scheduler import CCPScheduler
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention as attn_pt
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import CCPDispatcher, ServeEngine


def _cfgs(arch):
    """The smoke config of ``arch`` in the reference and in the port."""
    return get_config_jax(arch, smoke=True), get_config(arch, smoke=True)

@pytest.fixture(scope="module")
def engines():
    """The reference's engine (mistral-nemo smoke, max_len 48, as
    tests/test_serve_loop.py) and the port's on the same weights."""
    cfg_j, cfg_p = _cfgs("mistral-nemo-12b")
    model_j = build_jax(cfg_j)
    params_j, _ = model_j.init(jax.random.PRNGKey(0))
    params_p = interop.lm_params_from_numpy(cfg_p, jax.tree.map(np.asarray, params_j),
                                            device="cpu")
    return (ServeEngineJax(model_j, params_j, max_len=48),
            ServeEngine(build_model(cfg_p), params_p, max_len=48, device="cpu"), cfg_p)


def test_generate_equals_reference_and_is_deterministic(engines):
    eng_j, eng_p, cfg = engines
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 8)).astype(np.int32)
    out = eng_p.generate(prompts, n_new=6)
    assert out.shape == (3, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, eng_j.generate(prompts, n_new=6))
    np.testing.assert_array_equal(out, eng_p.generate(prompts, n_new=6))
    assert out.min() >= 0 and out.max() < cfg.vocab
    assert eng_p.generate(prompts, n_new=0).shape == (3, 0)


def test_generate_matches_forward_argmax(engines):
    """First generated token == argmax of the full forward pass."""
    _, eng, cfg = engines
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    out = eng.generate(prompts, n_new=1)
    logits = eng.model.forward(eng.params, torch.as_tensor(prompts))
    np.testing.assert_array_equal(out[:, 0], torch.argmax(logits[:, -1], dim=-1).numpy())


def test_dispatcher_shifts_load_to_fast_replica(engines):
    _, eng, cfg = engines
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32) for _ in range(16)]

    def fast(b):
        return eng.generate(b, n_new=2)

    def slow(b):  # 0.2 s: well clear of the CPU's noise on a 10-20 ms generate
        time.sleep(0.2)
        return eng.generate(b, n_new=2)

    results, allocs = CCPDispatcher([fast, slow]).run(batches)
    assert all(r is not None and r.shape == (2, 2) for r in results)
    assert all(int(a.sum()) <= 8 for a in allocs)
    if len(allocs) >= 2:
        last = allocs[-1]
        assert last[0] >= last[1], f"fast replica must get >= share: {allocs}"


def test_scheduler_equals_reference():
    """The same observations (a straggler, a dead worker that times out
    three times, a recovery) through both schedulers: equal allocations,
    dead masks and estimates."""
    ours, ref = CCPScheduler(n_workers=4), CCPSchedulerJax(n_workers=4)
    rng = np.random.default_rng(3)
    dead = []
    for step in range(10):
        total = int(rng.integers(4, 17))
        a, r = ours.allocation(total), ref.allocation(total)
        np.testing.assert_array_equal(a, r)
        assert int(a.sum()) == total
        d = np.array([0.1, 0.3, 0.12, 0.05]) * np.maximum(a, 1) * rng.uniform(0.9, 1.1, 4)
        if 2 <= step <= 4:
            d[3] = np.inf  # worker 3 stops answering
        ours.observe_step(d)
        ref.observe_step(d)
        np.testing.assert_array_equal(ours.dead_mask(), ref.dead_mask())
        np.testing.assert_allclose(ours.e_beta, ref.e_beta, rtol=1e-6)
        np.testing.assert_allclose(ours.timeout_deadline(), ref.timeout_deadline(), rtol=1e-6)
        dead.append(ours.dead_mask().copy())
        if step == 4:  # three doublings: declared dead, and given nothing
            assert ours.allocation(12)[3] == 0 and ref.allocation(12)[3] == 0
    assert [bool(m[3]) for m in dead] == [False] * 4 + [True] + [False] * 5
    assert not np.any([m[:3] for m in dead])
    assert ours.state.e_beta.device.type == "cpu"


def test_cache_overrun_reference_clamps_port_refuses():
    """The reference's cache write is dynamic_update_slice, which clamps the
    start so the write fits: a write past max_len silently overwrites the
    last slots.  The port writes in place and refuses."""
    cfg_j, cfg_p = _cfgs("phi4-mini-3.8b")
    hkv, hd = cfg_p.n_kv_heads, cfg_p.head_dim_
    ref = jnp.zeros((1, hkv, 8, hd))
    new = jnp.ones((1, hkv, 3, hd))
    clamped = np.asarray(attn_jax._dyn_update(ref, new, 7))  # pos 7 + 3 tokens > 8 slots
    assert clamped[0, 0, 5:].min() == 1 and clamped[0, 0, :5].max() == 0  # written at 5..7
    cache = attn_pt.init_cache(cfg_p, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="overruns max_len 8"):
        attn_pt._write(cache["k"], torch.ones((1, hkv, 3, hd)), 7)
    assert float(cache["k"].abs().max()) == 0
    attn_pt._write(cache["k"], torch.ones((1, hkv, 3, hd)), 5)  # fits exactly
    model = build_model(cfg_p)
    params = model.init(0, device="cpu")
    caches = model.init_cache(1, 8, device="cpu")
    _, caches = model.prefill(params, torch.zeros((1, 6), dtype=torch.int32), caches)
    with pytest.raises(ValueError, match="overruns"):
        model.prefill(params, torch.zeros((1, 3), dtype=torch.int32), caches)


def test_sample_mode_reference_ignores_port_refuses(engines):
    """The reference's ServeEngine stores ``sample`` and decodes greedily
    whatever it says; the port refuses anything but "greedy" rather than
    give greedy tokens under another name."""
    eng_j, eng_p, cfg = engines
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    sampled = ServeEngineJax(eng_j.model, eng_j.params, max_len=48, sample="top_k")
    assert sampled.sample == "top_k"
    np.testing.assert_array_equal(sampled.generate(prompts, n_new=3),
                                  eng_j.generate(prompts, n_new=3))
    with pytest.raises(ValueError, match="only greedy decoding is ported"):
        ServeEngine(eng_p.model, eng_p.params, max_len=48, sample="top_k", device="cpu")


def test_launch_serve_runs_on_cpu(capsys):
    results = serve_launch.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
                                 "--requests", "3", "--batch", "2", "--prompt-len", "6",
                                 "--new-tokens", "3", "--max-len", "16", "--replicas", "2"])
    assert len(results) == 3 and all(r.shape == (2, 3) for r in results)
    out = capsys.readouterr().out
    assert "dispatch allocations" in out and "tok/s" in out and "on cpu" in out
