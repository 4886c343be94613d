"""Port parity for flash attention (K4): the port's entry
(``repro_torch.kernels.flash_attention``, which runs its plain version on CPU
tensors) against the JAX reference's Pallas kernel in interpret mode and its
plain versions, on the same numpy inputs.  The CUDA kernel itself is held
against its plain version in tests/test_torch_cuda.py (card only).

Tolerances are the reference suite's (tests/test_kernels_flash_attention.py):
the sweep rtol float32 2e-5 / bfloat16 2e-2 with atol eight times that
(the kernel sums keys tile by tile, the plain version in one pass, and a
bf16 output rounds after either); window, softcap, non-causal, unaligned and
decode rtol 2e-5 / atol 2e-4; the property test 3e-5 / 3e-4.  The plain
versions against the reference's plain versions (the same fp32 arithmetic,
summed in another order by another library) and the cached-attention
equivalence take the float32 sweep tolerance.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_attention import attention_flops as flops_jax
from repro.kernels.flash_attention import flash_attention as fa_jax
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_chunked as chunked_jax
from repro.kernels.flash_attention.ref import attention_ref as ref_jax
from repro.models import attention as attn_jax
from repro.models.config import ModelConfig as ModelConfigJax
from repro_torch.kernels.flash_attention import (attention_chunked, attention_flops,
                                                 attention_ref, flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels.flash_attention.ops import CHUNKED_THRESHOLD

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, Hq, Hkv, Tq, Tk, D, dtype="float32"):
    """The reference suite's draws (q, k scaled by 0.5), from numpy, rounded
    to the working type once so both sides start equal."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, Hq, Tq, D)).astype(np.float32) * 0.5,
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32) * 0.5,
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in arrs]
    return arrs


def _both(arrs, dtype="float32"):
    return ([jnp.asarray(a).astype(JNP[dtype]) for a in arrs],
            [torch.as_tensor(a).to(PT[dtype]) for a in arrs])


def _close(out_t, ref_j, rtol, atol):
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(ref_j, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,Tq,Tk,D,bq,bk",
    [
        (1, 2, 2, 32, 32, 16, 16, 16),     # MHA
        (2, 4, 2, 64, 64, 32, 32, 16),     # GQA group 2
        (1, 8, 1, 64, 64, 32, 16, 32),     # MQA
        (1, 2, 2, 128, 128, 64, 128, 128), # MXU-aligned
        (2, 2, 1, 48, 96, 16, 16, 16),     # Tk > Tq (prefix cache)
    ],
)
def test_flash_causal_sweep_matches_pallas(B, Hq, Hkv, Tq, Tk, D, bq, bk, dtype):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(0, B, Hq, Hkv, Tq, Tk, D, dtype), dtype)
    off = Tk - Tq
    pallas = fa_jax(qj, kj, vj, causal=True, q_offset=off, use_pallas=True,
                    interpret=True, bq=bq, bk=bk)
    out = flash_attention(qt, kt, vt, causal=True, q_offset=off)
    assert out.shape == (B, Hq, Tq, D) and out.dtype == PT[dtype]
    _close(out, pallas, TOL[dtype], TOL[dtype] * 8)


@pytest.mark.parametrize("window", [8, 16, 64])
def test_flash_sliding_window_matches_pallas(window):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(1, 1, 2, 2, 64, 64, 32))
    pallas = fa_jax(qj, kj, vj, causal=True, window=window, use_pallas=True,
                    interpret=True, bq=16, bk=16)
    _close(flash_attention(qt, kt, vt, causal=True, window=window), pallas, 2e-5, 2e-4)


@pytest.mark.parametrize("softcap", [10.0, 30.0, 50.0])
def test_flash_softcap_matches_pallas(softcap):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(2, 1, 2, 1, 32, 32, 16))
    pallas = fa_jax(qj, kj, vj, causal=True, softcap=softcap, use_pallas=True,
                    interpret=True, bq=16, bk=16)
    _close(flash_attention(qt, kt, vt, causal=True, softcap=softcap), pallas, 2e-5, 2e-4)


def test_flash_noncausal_matches_pallas():
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(3, 2, 2, 2, 32, 48, 16))
    pallas = fa_jax(qj, kj, vj, causal=False, use_pallas=True, interpret=True, bq=16, bk=16)
    _close(flash_attention(qt, kt, vt, causal=False), pallas, 2e-5, 2e-4)


def test_flash_unaligned_lengths_match_pallas():
    """Tq/Tk not multiples of the block sizes: the reference pads, the port's
    kernel masks the ragged edge itself."""
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(4, 1, 2, 2, 37, 53, 16))
    pallas = fa_jax(qj, kj, vj, causal=True, q_offset=53 - 37, use_pallas=True,
                    interpret=True, bq=16, bk=16)
    _close(flash_attention(qt, kt, vt, causal=True, q_offset=53 - 37), pallas, 2e-5, 2e-4)


def test_flash_decode_shape_matches_pallas():
    """Tq=1 against a long KV cache (the serve_step shape)."""
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(5, 4, 8, 2, 1, 256, 32))
    pallas = fa_jax(qj, kj, vj, causal=True, q_offset=255, use_pallas=True,
                    interpret=True, bq=16, bk=64)
    _close(flash_attention(qt, kt, vt, causal=True, q_offset=255), pallas, 2e-5, 2e-4)


@settings(max_examples=8, deadline=None)
@given(
    Tq=st.integers(8, 48),
    extra=st.integers(0, 32),
    Hkv=st.sampled_from([1, 2]),
    group=st.sampled_from([1, 2, 4]),
    window=st.sampled_from([None, 8, 32]),
    seed=st.integers(0, 50),
)
def test_property_flash_matches_pallas(Tq, extra, Hkv, group, window, seed):
    Tk = Tq + extra
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(seed, 1, Hkv * group, Hkv, Tq, Tk, 16))
    pallas = fa_jax(qj, kj, vj, causal=True, window=window, q_offset=extra,
                    use_pallas=True, interpret=True, bq=16, bk=16)
    out = flash_attention(qt, kt, vt, causal=True, window=window, q_offset=extra)
    _close(out, pallas, 3e-5, 3e-4)


# --- the plain versions, with q_offset and a valid prefix ---------------------

@pytest.mark.parametrize(
    "Tq,Tk,q_offset,kv_len,window,softcap,causal",
    [
        (5, 64, 30, [35, 12], None, None, True),       # prefill into a cache
        (1, 64, 40, [41, 41], 8, None, True),          # windowed decode
        (7, 48, 0, [7, 3], None, 30.0, True),          # softcap, short rows
        (6, 40, 2, [20, 0], None, None, False),        # non-causal; a row with no key
        (4, 2500, 2300, [2304, 1000], None, None, True),  # above the chunk threshold
        (3, 2100, 2000, [2003, 2003], 64, 50.0, True),
    ],
)
def test_plain_versions_match_reference(Tq, Tk, q_offset, kv_len, window, softcap, causal):
    B, Hq, Hkv, D = 2, 4, 2, 8
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(Tk + Tq, B, Hq, Hkv, Tq, Tk, D))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    lens_j, lens_t = jnp.asarray(kv_len, jnp.int32), torch.as_tensor(kv_len)
    tol = TOL["float32"]
    ref = ref_jax(qj, kj, vj, kv_len=lens_j, **kw)
    _close(attention_ref(qt, kt, vt, kv_len=lens_t, **kw), ref, tol, tol * 8)
    chunked = chunked_jax(qj, kj, vj, kv_len=lens_j, chunk=16, **kw)
    _close(attention_chunked(qt, kt, vt, kv_len=lens_t, chunk=16, **kw), chunked, tol, tol * 8)
    _close(attention_chunked(qt, kt, vt, kv_len=lens_t, chunk=16, **kw), ref, tol, tol * 8)
    # The reference's cached-attention dispatch (attention_ref up to the
    # threshold, chunked above) against the port's, at one valid length.
    cfg = ModelConfigJax(name="t", n_layers=1, d_model=8, n_heads=Hq, n_kv_heads=Hkv,
                         d_ff=8, vocab=8, attn_softcap=softcap)
    cached = attn_jax._attend_cached(qj, kj, vj, kv_len[0], q_offset, cfg, window=window,
                                     causal=causal, use_pallas=False, interpret=False)
    out = flash_attention(qt, kt, vt, tk_valid=kv_len[0], **kw)
    assert (Tk > CHUNKED_THRESHOLD) == (Tk > 2048)
    _close(out, cached, tol, tol * 8)


@pytest.mark.parametrize(
    "pos,T,window",
    [(0, 23, None),    # prefill
     (23, 1, None),    # decode
     (40, 1, 8),       # windowed decode
     (0, 17, 8)],      # windowed prefill
)
def test_reference_kernel_with_runtime_offsets_equals_cached_attention(pos, T, window):
    """Inside the reference: its Pallas kernel with q_offset=pos and
    tk_valid=pos+T over a zero-padded cache buffer computes what its serving
    path (attention_ref with kv_len=pos+T) computes.  This is the equivalence
    that lets the port send prefill and decode to K4; the port's plain route
    is held to the same result."""
    B, Hq, Hkv, D, slots = 2, 4, 2, 16, 64
    q, k, v = _qkv(pos * 7 + T, B, Hq, Hkv, T, pos + T, D)
    ck = np.zeros((B, Hkv, slots, D), np.float32)
    cv = np.zeros((B, Hkv, slots, D), np.float32)
    ck[:, :, :pos + T], cv[:, :, :pos + T] = k, v
    bq = 16 if T > 1 else 1
    tq = -(-T // bq) * bq
    q_pad = np.zeros((B, Hq, tq, D), np.float32)
    q_pad[:, :, :T] = q
    kernel = flash_attention_pallas(jnp.asarray(q_pad), jnp.asarray(ck), jnp.asarray(cv),
                                    causal=True, window=window, bq=bq, bk=16, q_offset=pos,
                                    tk_valid=pos + T, interpret=True)[:, :, :T]
    served = ref_jax(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), causal=True,
                     window=window, q_offset=pos, kv_len=jnp.full((B,), pos + T, jnp.int32))
    tol = TOL["float32"]
    np.testing.assert_allclose(np.asarray(kernel), np.asarray(served), rtol=tol, atol=tol * 8)
    out = flash_attention(*(torch.as_tensor(a) for a in (q, ck, cv)), causal=True,
                          window=window, q_offset=pos, tk_valid=pos + T)
    _close(out, served, tol, tol * 8)


def test_attention_flops_equal_reference():
    for args in [(4, 24, 1023, 1023, 128, True, None), (4, 24, 1, 1040, 128, True, None),
                 (1, 2, 37, 53, 16, True, None), (2, 4, 64, 64, 32, True, 8),
                 (1, 2, 32, 48, 16, False, None), (1, 2, 16, 40, 8, False, 4)]:
        assert attention_flops(*args) == flops_jax(*args)
    # The prefill shape of chip_smoke.py: 25.74 GFLOP a launch.
    assert round(attention_flops(4, 24, 1023, 1023, 128, True, None) / 1e9, 2) == 25.74


def test_cpu_dispatch_and_route_refusals():
    """CPU tensors take the plain version; asking for the kernel on the CPU,
    or handing the CUDA wrapper a CPU tensor, raises (no fallback)."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(6, 1, 2, 1, 4, 8, 8))
    with pytest.raises(ValueError, match="use_kernel=True"):
        flash_attention(q, k, v, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)
    torch.testing.assert_close(flash_attention(q, k, v, use_kernel=False),
                               attention_ref(q, k, v), rtol=0, atol=0)


# --- split-K decode: the launch plan and the plain model of the split ----------

from repro_torch.kernels.flash_attention.kernel import split_plan  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (attention_split,  # noqa: E402
                                                     attention_split_partials)

H100_SMS = 132


def test_split_plan_at_the_serving_shapes():
    """phi4-mini's decode step (B 4, Hq 24, Hkv 8, a 2048-slot cache): 32
    unsplit CTAs for 132 SMs, so 16 chunks of 128 keys, 9 of them holding
    keys below tk_valid 1041: 288 working CTAs.  The plan reads the buffer's
    length only, so every decode step gets the same grid.  The prefill
    (1536 CTAs) is not split."""
    plan = split_plan(4, 24, 8, 1, 2048, 128, H100_SMS)
    assert (plan.bq, plan.n_split, plan.chunk) == (8, 16, 128)
    assert plan.ctas(4, 8) == 512 and plan.working_ctas(4, 8, 1041) == 288 >= H100_SMS
    assert all(split_plan(4, 24, 8, 1, 2048, 128, H100_SMS) == plan for _ in range(2))
    prefill = split_plan(4, 24, 8, 1023, 2048, 128, H100_SMS)
    assert prefill.n_split == 1 and prefill.ctas(4, 8) == 1536
    long = split_plan(1, 8, 1, 1, 131072, 128, H100_SMS)  # chunks grow past 64 splits
    assert long.n_split <= 64 and long.chunk % 64 == 0 and long.n_split * long.chunk >= 131072
    assert split_plan(1, 2, 2, 32, 32, 16, H100_SMS).n_split == 1  # too few keys to split


# (Tq, Tk, q_offset, tk_valid, window, softcap): tk_valid inside the first
# chunk, on a chunk edge, equal to the buffer; a window that empties whole
# chunks; softcap; a short query block (prefill into a cache).
SPLIT_CASES = [
    (1, 1024, 49, 50, None, None),
    (1, 1024, 255, 256, None, None),
    (1, 1024, 1023, 1024, None, None),
    (1, 1024, 899, 900, 100, None),
    (1, 1024, 599, 600, None, 30.0),
    (5, 1024, 700, 705, None, None),
]


@pytest.mark.parametrize("Tq,Tk,q_offset,tk_valid,window,softcap", SPLIT_CASES)
def test_split_attention_matches_reference(Tq, Tk, q_offset, tk_valid, window, softcap):
    """Partials per 128-key chunk of the buffer, then the combine, equal
    ``attention_ref`` and the JAX reference over the valid prefix, with NaN
    in every stale slot beyond tk_valid (masked keys weigh exactly 0)."""
    B, Hq, Hkv, D = 2, 6, 2, 16
    q, k, v = _qkv(Tk + tk_valid, B, Hq, Hkv, Tq, Tk, D)
    k[:, :, tk_valid:], v[:, :, tk_valid:] = np.nan, np.nan
    (qj, kj, vj), (qt, kt, vt) = _both([q, k, v])
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    out = attention_split(qt, kt, vt, chunk=128, kv_len=tk_valid, **kw)
    tol = TOL["float32"]
    _close(out, attention_ref(qt, kt[:, :, :tk_valid], vt[:, :, :tk_valid], **kw), tol, tol * 8)
    ref = ref_jax(qj, kj[:, :, :tk_valid], vj[:, :, :tk_valid], **kw)
    _close(out, ref, tol, tol * 8)
    m, l, _ = attention_split_partials(qt, kt, vt, chunk=128, kv_len=tk_valid, **kw)
    assert m.shape[0] == Tk // 128
    empty = torch.arange(Tk // 128) * 128 >= tk_valid  # chunks wholly beyond tk_valid
    assert bool((l[empty] == 0).all()) and bool((m[empty] == -1e30).all())
    if window is not None:  # chunks wholly before the window's horizon are empty too
        before = (torch.arange(Tk // 128) + 1) * 128 <= q_offset - window + 1
        assert bool(before.any()) and bool((l[before] == 0).all())


def test_split_attention_gives_zero_where_no_key_is_valid():
    q, k, v = (torch.as_tensor(a) for a in _qkv(9, 1, 4, 2, 1, 512, 8))
    out = attention_split(q, k, v, chunk=128, causal=True, q_offset=0, kv_len=0)
    assert torch.equal(out, torch.zeros_like(q))


# --- the tensor-core instance: its launch rule and its 3xTF32 arithmetic -------

from repro_torch.kernels.flash_attention.ref import attention_3xtf32  # noqa: E402

# FA_TOL["float32"] of chip_smoke.py and tests/test_torch_cuda.py: the
# reference suite's float32 tolerance, rtol 2e-5 and atol 1.6e-4.
FA_RTOL, FA_ATOL = 2e-5, 1.6e-4
# tests/test_torch_cuda.py's FA_CASES that the tensor-core instance serves
# (float32, more than 8 rows a KV head, D <= 128, no key split on 132 SMs):
# (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset, tk_valid).
WG_FA_CASES = [
    (1, 2, 2, 32, 32, 16, True, None, None, 0, None),      # MHA
    (2, 4, 2, 64, 64, 32, True, None, None, 0, None),      # GQA group 2
    (1, 8, 1, 64, 64, 32, True, None, None, 0, None),      # MQA
    (1, 2, 2, 128, 128, 64, True, None, None, 0, None),
    (2, 2, 1, 48, 96, 16, True, None, None, 48, None),     # Tk > Tq
    (1, 2, 2, 64, 64, 32, True, 8, None, 0, None),         # windows
    (1, 2, 2, 64, 64, 32, True, 16, None, 0, None),
    (1, 2, 2, 64, 64, 32, True, 64, None, 0, None),
    (1, 2, 1, 32, 32, 16, True, None, 10.0, 0, None),      # softcaps
    (1, 2, 1, 32, 32, 16, True, None, 30.0, 0, None),
    (1, 2, 1, 32, 32, 16, True, None, 50.0, 0, None),
    (2, 2, 2, 32, 48, 16, False, None, None, 0, None),     # non-causal
    (1, 2, 2, 37, 53, 16, True, None, None, 16, None),     # unaligned
    (2, 6, 2, 23, 64, 24, True, None, None, 0, 23),        # prefill into a cache buffer
    (1, 4, 2, 5, 40, 8, True, None, None, 3, 0),           # no valid key: zero rows
]


def _fa_share(out, ref) -> float:
    """max |out - ref| / (atol + rtol |ref|): at most 1 within FA_TOL."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(out - ref) / (FA_ATOL + FA_RTOL * np.abs(ref))).max())


def test_split_plan_takes_the_tensor_cores_for_float32_prefill():
    """The launch rule of csrc/flash_attention.cu's dispatch: float32 with
    aligned rows (``tensor_cores``), more than 8 rows a KV head, D <= 128 and
    no key split run the 3xTF32 wgmma instance, 128 rows a CTA; everything
    else keeps the CUDA-core plan it had."""
    prefill = split_plan(4, 24, 8, 1023, 2048, 128, H100_SMS, True)
    assert prefill.wgmma and (prefill.bq, prefill.tiles, prefill.n_split) == (128, 24, 1)
    assert prefill.ctas(4, 8) == 768
    assert split_plan(4, 24, 8, 1023, 2048, 128, H100_SMS) == \
        split_plan(4, 24, 8, 1023, 2048, 128, H100_SMS, False)
    assert not split_plan(4, 24, 8, 1023, 2048, 128, H100_SMS, False).wgmma  # bf16, unaligned
    assert not split_plan(4, 24, 8, 1, 2048, 128, H100_SMS, True).wgmma      # decode
    assert not split_plan(1, 8, 1, 1, 64, 64, H100_SMS, True).wgmma          # 8 rows
    assert split_plan(1, 9, 1, 1, 64, 64, H100_SMS, True).wgmma              # 9 rows
    assert not split_plan(1, 4, 4, 70, 200, 256, H100_SMS, True).wgmma       # D 256
    split = split_plan(1, 6, 2, 5, 1024, 64, H100_SMS, True)                 # few CTAs: split
    assert not split.wgmma and split.n_split > 1
    assert split == split_plan(1, 6, 2, 5, 1024, 64, H100_SMS, False)
    for c in WG_FA_CASES:
        assert split_plan(*c[:6], H100_SMS, True).wgmma


def test_k4_3xtf32_meets_fp32_tolerance_and_tf32_alone_does_not():
    """Why the tensor-core instance runs 3xTF32: at one (b, KV head) of the
    serving prefill (3 q heads, 1023 causal tokens, D 128, inputs N(0, 1)),
    the plain model of its arithmetic stays well within FA_TOL of an fp64
    attention, while one TF32 product for Q K^T and P V misses it by more
    than 5x (its TF32 truncation: 10 mantissa bits)."""
    rng = np.random.default_rng(15)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 3, 1023, 128), (1, 1, 1023, 128), (1, 1, 1023, 128)))
    s = (q.astype(np.float64) @ np.swapaxes(k.astype(np.float64), -1, -2)) / np.sqrt(128)
    s = np.where(np.tril(np.ones((1023, 1023), bool)), s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    exact = (p / p.sum(axis=-1, keepdims=True)) @ v.astype(np.float64)
    qt, kt, vt = (torch.as_tensor(a) for a in (q, k, v))
    three = _fa_share(attention_3xtf32(qt, kt, vt).numpy(), exact)
    one = _fa_share(attention_3xtf32(qt, kt, vt, products=1).numpy(), exact)
    plain = _fa_share(attention_ref(qt, kt, vt).numpy(), exact)
    assert three <= 0.1, three
    assert one > 5.0, one
    assert plain <= 0.1, plain


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap,q_offset,tk_valid", WG_FA_CASES)
def test_attention_3xtf32_matches_reference(B, Hq, Hkv, Tq, Tk, D, causal, window, softcap,
                                            q_offset, tk_valid):
    """The plain model of the tensor-core instance equals ``attention_ref``
    and the JAX reference within FA_TOL on every FA_CASES shape the instance
    serves, with NaN in every slot beyond tk_valid."""
    q, k, v = _qkv(Tq * 1000 + Tk + D, B, Hq, Hkv, Tq, Tk, D)
    valid = Tk if tk_valid is None else tk_valid
    k[:, :, valid:], v[:, :, valid:] = np.nan, np.nan
    (qj, kj, vj), (qt, kt, vt) = _both([q, k, v])
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    out = attention_3xtf32(qt, kt, vt, kv_len=valid, **kw)
    if valid == 0:
        assert torch.equal(out, torch.zeros_like(qt))
        return
    ref = attention_ref(qt, kt[:, :, :valid], vt[:, :, :valid], **kw)
    torch.testing.assert_close(out, ref, rtol=FA_RTOL, atol=FA_ATOL)
    _close(out, ref_jax(qj, kj[:, :, :valid], vj[:, :, :valid], **kw), FA_RTOL, FA_ATOL)
