"""The gradient of attention on the port: the plain backward
(``ref.attention_bwd_ref``, the oracle of K4's backward kernel) against
``jax.vjp`` of the reference's ``attention_ref`` and against torch autograd
of the port's ``attention_ref``, over the kernel's cases; the autograd
function (``FlashAttentionFn``) under ``torch.autograd.gradcheck`` in float64
with the plain versions as its forward and backward; and the op's routing:
CUDA tensors that require grad go through the function (K4's forward with
its log-sum-exp, then the backward), others through K4's forward alone.

Tolerances: against the reference and torch autograd, each gradient within
2e-5 of its max |.| plus 2e-5 relative (float32 sums in another order; the
softcap's derivative through tanh); the log-sum-exp and the forward of the
function rtol/atol 1e-6; gradcheck's own float64 defaults.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as attention_ref_jax
from repro_torch.kernels.flash_attention import autograd as fa_autograd
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.autograd import FlashAttentionFn
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_fwd_ref,
                                                     attention_lse_ref, attention_ref)

TOL = 2e-5
# (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset, kv_len): GQA
# groups 1, 3 and 4, ragged rows, windows, softcaps, a valid prefix with an
# offset, rows with no valid key (a negative offset; kv_len 0), D 64 and 256.
CASES = [
    (1, 2, 2, 16, 16, 8, True, None, None, 0, None),
    (2, 6, 2, 13, 13, 16, True, None, None, 0, None),
    (1, 8, 2, 9, 14, 16, False, None, None, 0, None),
    (1, 4, 2, 20, 20, 8, True, 4, None, 0, None),
    (1, 4, 1, 12, 12, 16, True, None, 30.0, 0, None),
    (2, 4, 2, 11, 11, 24, True, 8, 50.0, 0, None),
    (2, 6, 2, 7, 20, 8, True, None, None, 5, 12),
    (1, 4, 2, 8, 10, 16, True, None, None, -3, None),
    (1, 4, 2, 5, 9, 8, True, None, None, 3, 0),
    (1, 2, 1, 6, 8, 64, True, None, 10.0, 2, 8),
    (1, 2, 2, 4, 5, 256, True, 3, None, 1, 5),
]
IDS = [f"B{c[0]}H{c[1]}-{c[2]}T{c[3]}-{c[4]}D{c[5]}" + ("c" if c[6] else "n")
       + f"w{c[7]}s{c[8]}o{c[9]}v{c[10]}" for c in CASES]


def _inputs(case, seed=0):
    B, Hq, Hkv, Tq, Tk, D = case[:6]
    rng = np.random.default_rng(seed + 31 * Tq + Tk)
    q = (rng.standard_normal((B, Hq, Tq, D)) * 0.7).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, Tk, D)) * 0.7).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    return q, k, v, do


def _opts(case):
    return dict(causal=case[6], window=case[7], softcap=case[8], q_offset=case[9])


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= TOL * scale + TOL * np.abs(want)), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp_of_the_reference(case):
    q, k, v, do = _inputs(case)
    kw, kv = _opts(case), case[10]
    kv_j = None if kv is None else jnp.full((q.shape[0],), kv, jnp.int32)

    @jax.jit
    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: attention_ref_jax(q, k, v, kv_len=kv_j, **kw), q, k, v)
        return out, vjp(do)

    out_j, grads_j = out_and_grads(q, k, v, do)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    out, lse = attention_fwd_ref(qt, kt, vt, kv_len=kv, **kw)
    _close(out.numpy(), out_j)
    grads = attention_bwd_ref(qt, kt, vt, out, torch.tensor(do), lse, kv_len=kv, **kw)
    for g, gj in zip(grads, grads_j):
        assert g.dtype == torch.float32
        _close(g.numpy(), gj)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_torch_autograd_of_the_port(case):
    q, k, v, do = (torch.tensor(x) for x in _inputs(case, seed=1))
    kw, kv = _opts(case), case[10]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention_ref(*leaves, kv_len=kv, **kw)
    out.backward(do)
    lse = attention_lse_ref(q, k, v, kv_len=kv, **kw)
    grads = attention_bwd_ref(q, k, v, out.detach(), do, lse, kv_len=kv, **kw)
    for g, t in zip(grads, leaves):
        assert bool(torch.isfinite(g).all())
        _close(g.numpy(), t.grad.numpy())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_and_forward_with_lse(case):
    q, k, v, _ = (torch.tensor(x) for x in _inputs(case, seed=2))
    kw, kv = _opts(case), case[10]
    out, lse = attention_fwd_ref(q, k, v, kv_len=kv, **kw)
    torch.testing.assert_close(out, attention_ref(q, k, v, kv_len=kv, **kw), rtol=1e-6, atol=1e-6)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, kv_len=kv, **kw))
    # -inf exactly on the rows with no valid key, where the output is zero
    empty = torch.isneginf(lse)
    assert torch.equal(empty[..., None].expand_as(out), (out == 0) & empty[..., None])
    if kv == 0 or case[9] < 0:
        assert bool(empty.any())


# Small shapes for gradcheck (its numerical Jacobian costs a forward an
# input element): causal GQA, window and softcap, an offset into a valid
# prefix, rows with no valid key, and no valid key at all.
GRADCHECK = [
    (1, 4, 2, 5, 5, 4, True, None, None, 0, None),
    (1, 2, 1, 6, 6, 4, True, 3, 5.0, 0, None),
    (1, 2, 1, 4, 9, 4, False, None, 2.0, 0, None),
    (1, 4, 2, 3, 8, 4, True, None, None, 2, 5),
    (1, 2, 2, 5, 6, 4, True, None, None, -2, None),
    (1, 2, 1, 3, 4, 4, True, None, None, 1, 0),
]


@pytest.mark.parametrize("case", GRADCHECK)
def test_autograd_function_passes_gradcheck_in_float64(case):
    B, Hq, Hkv, Tq, Tk, D = case[:6]
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
               for shape in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
    kw, kv = _opts(case), case[10]

    def f(q, k, v):
        return FlashAttentionFn.apply(q, k, v, kw["causal"], kw["window"], kw["softcap"],
                                      kw["q_offset"], kv, attention_fwd_ref, attention_bwd_ref)

    assert torch.autograd.gradcheck(f, (q, k, v))


def test_the_cpu_route_stays_the_differentiable_plain_version():
    q, k, v, do = (torch.tensor(x) for x in _inputs(CASES[5]))
    kw = _opts(CASES[5])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, **kw)
    out.backward(do)
    lse = attention_lse_ref(q, k, v, **kw)
    for g, t in zip(attention_bwd_ref(q, k, v, out.detach(), do, lse, **kw), leaves):
        _close(g.numpy(), t.grad.numpy())


def test_cuda_calls_that_record_grad_take_the_function(monkeypatch):
    """The op's routing, on CPU tensors that claim to be on the card: with
    grad recorded it runs the function (the kernels' forward with an lse
    buffer, then the backward kernel; here their plain stand-ins) and q, k
    and v get their gradients; under no_grad, or with nothing requiring
    grad, it calls K4's forward alone, without an lse."""
    calls = []

    def fake_cuda(q, k, v, *, causal, window, softcap, q_offset, tk_valid, lse=None):
        calls.append(("fwd", lse is not None))
        valid = k.shape[2] if tk_valid is None else tk_valid
        out, l = attention_fwd_ref(q, k[:, :, :valid], v[:, :, :valid], causal=causal,
                                   window=window, softcap=softcap, q_offset=q_offset)
        if lse is not None:
            lse.copy_(l)
        return out

    def fake_bwd(q, k, v, o, do, lse, *, causal, window, softcap, q_offset, tk_valid):
        calls.append(("bwd", True))
        return attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset, kv_len=tk_valid)

    monkeypatch.setattr(fa_autograd, "flash_attention_cuda", fake_cuda)
    monkeypatch.setattr(fa_autograd, "flash_attention_bwd_cuda", fake_bwd)
    monkeypatch.setattr(fa_ops, "flash_attention_cuda", fake_cuda)
    q, k, v, do = (torch.tensor(x) for x in _inputs(CASES[6]))
    kw, kv = _opts(CASES[6]), CASES[6][10]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    out = fa_ops.flash_attention(*leaves, tk_valid=kv, **kw)
    out.backward(do)
    with torch.no_grad():
        fa_ops.flash_attention(*leaves, tk_valid=kv, **kw)
    fa_ops.flash_attention(q, k, v, tk_valid=kv, **kw)
    monkeypatch.undo()
    assert calls == [("fwd", True), ("bwd", True), ("fwd", False), ("fwd", False)]
    lse = attention_lse_ref(q, k, v, kv_len=kv, **kw)
    for g, t in zip(attention_bwd_ref(q, k, v, out.detach(), do, lse, kv_len=kv, **kw), leaves):
        assert t.grad is not None and bool(t.grad.abs().max() > 0)
        torch.testing.assert_close(t.grad, g)


def test_backward_wrapper_refuses_cpu_tensors_and_counts_two_launches_a_call():
    q, k, v, do = (torch.tensor(x) for x in _inputs(CASES[0]))
    lse = attention_lse_ref(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_kernel.flash_attention_bwd_cuda(q, k, v, q, do, lse)
    assert fa_kernel.BWD_LAUNCHES == 2
    plan = fa_kernel.bwd_plan(128)
    assert plan.ctas(4, 24, 8, 1024, 1024) == (48 * 8 * 4, 16 * 8 * 4)
    assert fa_kernel.bwd_plan(256).dmax == 256 and fa_kernel.bwd_plan(24).dmax == 64
