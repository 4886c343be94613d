"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA card and the CUDA toolkit; they are marked
``gpu`` and skip without a card.  The file imports nothing of JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerances are the reference suite's: float32 1e-5, bfloat16 2e-2, each
scaled by 1 + max|ref| (the kernel sums in another order than the plain
version, and a bf16 encode rounds in the plain version only).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fountain
from repro_torch.kernels.coded_matmul import (coded_matmul, coded_matmul_cuda,
                                              coded_matmul_ref)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# The reference suite's sweep shapes, a ragged k/n shape, several row tiles
# with dense parities of degree R/2 (16: every neighbour staged; 32: more
# neighbours than the float32 kernel stages), and ragged rows.
SHAPES = [(4, 2, 8, 16, 16), (6, 3, 16, 64, 32), (8, 4, 8, 128, 128),
          (3, 2, 32, 48, 24), (10, 5, 8, 32, 8), (4, 2, 8, 20, 13),
          (32, 8, 256, 300, 260), (64, 8, 16, 100, 72), (5, 3, 130, 77, 129)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["mask", "weights"])
@pytest.mark.parametrize("R,K,bm,kdim,ndim", SHAPES)
def test_cuda_kernel_matches_plain_version(card, R, K, bm, kdim, ndim, dtype, operand):
    code = fountain.make_lt_code(R=R, K=K, seed=R * 31 + K,
                                 parity_degree=R // 2 if R >= 32 else None)
    rng = np.random.default_rng(R + bm)
    a = torch.as_tensor(rng.standard_normal((R * bm, kdim)), dtype=dtype, device=card)
    x = torch.as_tensor(rng.standard_normal((kdim, ndim)), dtype=dtype, device=card)
    m = code.mask if operand == "mask" else code.weights
    idx, m = torch.as_tensor(code.idx, device=card), torch.as_tensor(m, device=card)
    before = coded_matmul_cuda.launches
    out = coded_matmul(a, x, idx, m, bm=bm)
    ref = coded_matmul_ref(a, x, idx, m, bm)
    torch.cuda.synchronize()
    assert coded_matmul_cuda.launches == before + 1
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = float((out.float() - ref.float()).abs().max())
    assert err <= TOL[dtype] * (1.0 + float(ref.float().abs().max()))


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(card):
    a = torch.zeros((16, 8), device=card)
    x = torch.zeros((8, 4), device=card)
    idx = torch.zeros((3, 2), dtype=torch.int32, device=card)
    w = torch.ones((3, 2), device=card)
    with pytest.raises(ValueError, match="int32"):
        coded_matmul_cuda(a, x, idx.long(), w, 8)
    with pytest.raises(ValueError, match="share one type"):
        coded_matmul_cuda(a, x.double(), idx, w, 8)
    with pytest.raises(ValueError, match="contiguous"):
        coded_matmul_cuda(a, x.t().contiguous().t(), idx, w, 8)
    with pytest.raises(ValueError, match="divisible"):
        coded_matmul_cuda(a, x, idx, w, 5)
    assert torch.equal(coded_matmul_cuda(a, x, idx, w, 8), torch.zeros((24, 4), device=card))


# --- K2 (lt_encode) and K3 (lt_decode) --------------------------------------

from repro_torch.core import decode as dec_pt  # noqa: E402
from repro_torch.kernels.coded_matmul.ref import lt_encode_ref  # noqa: E402
from repro_torch.kernels.lt_decode import (lt_decode, lt_decode_plan_cuda,  # noqa: E402
                                           lt_decode_ref, lt_decode_round_cuda)
from repro_torch.kernels.lt_encode import lt_encode, lt_encode_cuda  # noqa: E402

# The reference suite's test_lt_encode_sweep shapes (R, K, bm, cols), a
# ragged shape (cols not a multiple of the 16-byte vector, odd bm) and a
# wide one with several column tiles.
ENC_SHAPES = [(4, 2, 8, 16), (8, 4, 16, 128), (5, 3, 8, 24), (2, 1, 128, 256),
              (7, 5, 9, 37), (16, 16, 32, 2050)]
# The reference suite's test_lt_decode_kernel_vs_ref_vs_offline shapes
# (R, K, bm, cols, lost sources) and a ragged one.
DEC_SHAPES = [(12, 10, 4, 24, 3), (20, 24, 8, 16, 6), (8, 8, 16, 40, 2), (24, 30, 5, 77, 6)]


def _err_ok(out, ref, dtype):
    err = float((out.float() - ref.float()).abs().max())
    return err <= TOL[dtype] * (1.0 + float(ref.float().abs().max())), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["mask", "weights"])
@pytest.mark.parametrize("R,K,bm,cols", ENC_SHAPES)
def test_lt_encode_kernel_matches_plain_version(card, R, K, bm, cols, dtype, operand):
    code = fountain.make_lt_code(R=R, K=K, seed=R * 17 + K)
    a = torch.as_tensor(np.random.default_rng(R + cols).standard_normal((R * bm, cols)),
                        dtype=dtype, device=card)
    m = code.mask if operand == "mask" else code.weights
    idx, m = torch.as_tensor(code.idx, device=card), torch.as_tensor(m, device=card)
    before = lt_encode_cuda.launches
    out = lt_encode(a, idx, m, bm=bm)
    ref = lt_encode_ref(a, idx, m, bm)
    torch.cuda.synchronize()
    assert lt_encode_cuda.launches == before + 1
    assert out.shape == ref.shape and out.dtype == ref.dtype
    ok, err = _err_ok(out, ref, dtype)
    assert ok, err
    if operand == "weights" and (code.weights < 0).any():  # signs must not collapse
        as_mask = lt_encode(a, idx, torch.as_tensor(code.mask, device=card), bm=bm)
        assert not torch.equal(as_mask[R * bm:], out[R * bm:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,K,bm,cols,n_lost", DEC_SHAPES)
def test_lt_decode_kernel_matches_plain_version(card, R, K, bm, cols, n_lost, dtype):
    code = dec_pt.make_decoder_code(R, K, seed=R + K, d_max=8)
    x = torch.as_tensor(np.random.default_rng(R).standard_normal((R * bm, cols)),
                        dtype=dtype, device=card)
    coded = lt_encode_ref(x, torch.as_tensor(code.idx, device=card),
                          torch.as_tensor(code.weights, device=card), bm)
    lost = np.random.default_rng(n_lost).choice(R, size=n_lost, replace=False)
    keep = np.setdiff1d(np.arange(R + K), lost)
    plan = fountain.peel_decode_plan(code, keep)
    assert plan is not None
    crx = coded.reshape(R + K, bm, cols)[torch.as_tensor(keep, device=card)].reshape(-1, cols)
    before = lt_decode_plan_cuda.launches
    out = lt_decode(crx, plan, bm=bm)
    ref = lt_decode_ref(crx, plan, bm=bm)
    torch.cuda.synchronize()
    assert lt_decode_plan_cuda.launches == before + (1 if fountain.plan_rounds(plan) else 0)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    ok, err = _err_ok(out, ref, dtype)
    assert ok, err
    if dtype == torch.float32:
        torch.testing.assert_close(out, x, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["coded_matmul", "lt_encode", "lt_decode"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_non_finite_input(card, kernel, dtype):
    """An inf and a NaN in source block 0, which the codes' padding slots
    (index 0, weight 0) name: the plain versions turn 0 * inf into NaN in
    every row a padding slot reaches; the kernels skip padding slots and must
    give the same result, NaN-equal."""
    rng = np.random.default_rng(11)
    if kernel == "lt_decode":
        R, K, bm, cols = 20, 24, 8, 16
        code = dec_pt.make_decoder_code(R, K, seed=R + K, d_max=8)
        x = torch.as_tensor(rng.standard_normal((R * bm, cols)), dtype=dtype, device=card)
        coded = lt_encode_ref(x, torch.as_tensor(code.idx, device=card),
                              torch.as_tensor(code.weights, device=card), bm)
        keep = np.setdiff1d(np.arange(R + K), [2, 5, 11, 17])  # source 0 arrives
        plan = fountain.peel_decode_plan(code, keep)
        assert plan is not None and (plan.order_nbr_coef == 0).any()
        crx = coded.reshape(R + K, bm, cols)[torch.as_tensor(keep, device=card)].reshape(-1, cols)
        crx[2, 5], crx[6, 3] = torch.inf, torch.nan  # rows of source 0
        out, ref = lt_decode(crx, plan, bm=bm), lt_decode_ref(crx, plan, bm=bm)
    else:
        R, K, bm, cols = 6, 4, 8, 24
        code = fountain.make_lt_code(R=R, K=K, seed=1)
        a = torch.as_tensor(rng.standard_normal((R * bm, cols)), dtype=dtype, device=card)
        a[3, 5], a[6, 11] = torch.inf, torch.nan
        idx, w = torch.as_tensor(code.idx, device=card), torch.as_tensor(code.weights, device=card)
        if kernel == "lt_encode":
            out, ref = lt_encode(a, idx, w, bm=bm), lt_encode_ref(a, idx, w, bm)
        else:
            xm = torch.as_tensor(rng.standard_normal((cols, 12)), dtype=dtype, device=card)
            out, ref = coded_matmul(a, xm, idx, w, bm=bm), coded_matmul_ref(a, xm, idx, w, bm)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref).any())
    finite = ref.float()[torch.isfinite(ref)].abs().max()
    tol = TOL[dtype] * (1.0 + float(finite))
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol, equal_nan=True)


@pytest.mark.gpu
def test_lt_wrappers_refuse_what_the_kernels_do_not_take(card):
    a = torch.zeros((16, 8), device=card)
    idx = torch.zeros((3, 2), dtype=torch.int32, device=card)
    w = torch.ones((3, 2), device=card)
    with pytest.raises(ValueError, match="int32"):
        lt_encode_cuda(a, idx.long(), w, 8)
    with pytest.raises(ValueError, match="contiguous"):
        lt_encode_cuda(a.t().contiguous().t(), idx, w, 8)
    with pytest.raises(ValueError, match="divisible"):
        lt_encode_cuda(a, idx, w, 5)
    assert torch.equal(lt_encode_cuda(a, idx, w, 8), torch.zeros((24, 8), device=card))
    s1 = torch.zeros((1,), dtype=torch.int32, device=card)
    f1 = torch.ones((1,), device=card)
    with pytest.raises(ValueError, match="share one type"):
        lt_decode_round_cuda(a.double(), a, s1, s1, idx[:1], w[:1], f1, 8)
    with pytest.raises(ValueError, match="int32"):
        lt_decode_round_cuda(a, a.clone(), s1.long(), s1, idx[:1], w[:1], f1, 8)
    src = torch.zeros((16, 8), device=card)
    lt_decode_round_cuda(a + 2.0, src, s1, s1 + 1, idx[:1], torch.zeros((1, 2), device=card),
                         -f1, 8)
    assert torch.equal(src[8:], torch.full((8, 8), -2.0, device=card))
    assert torch.equal(src[:8], torch.zeros((8, 8), device=card))


# --- K4 (flash_attention) ------------------------------------------------------

from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,  # noqa: E402
                                                 flash_attention_cuda)

# The reference suite's tolerances (tests/test_kernels_flash_attention.py):
# rtol 2e-5 / atol 1.6e-4 in float32, 2e-2 / 1.6e-1 in bfloat16.
FA_TOL = {torch.float32: (2e-5, 1.6e-4), torch.bfloat16: (2e-2, 1.6e-1)}
# (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset, tk_valid): the
# reference suite's cases, then a cache buffer read up to tk_valid (prefill
# and decode), a row with no valid key, the wide head dims and the two
# phi4-mini shapes of chip_smoke.py at a smaller batch.
FA_CASES = [
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
    (4, 8, 2, 1, 256, 32, True, None, None, 255, None),    # decode
    (2, 6, 2, 23, 64, 24, True, None, None, 0, 23),        # prefill into a cache buffer
    (2, 6, 2, 1, 64, 24, True, 8, None, 40, 41),           # windowed decode in a buffer
    (1, 4, 2, 5, 40, 8, True, None, None, 3, 0),           # no valid key: zero rows
    (1, 4, 4, 70, 200, 256, True, 32, None, 5, 75),        # head dim 256
    (1, 24, 8, 100, 256, 128, True, None, None, 0, 100),   # phi4-mini prefill
    (2, 24, 8, 1, 2048, 128, True, None, None, 1040, 1041),  # phi4-mini decode
    # slice C3's shapes: recurrentgemma's MQA (10/1 heads, D 256) with a
    # window, prefill and a decode step in a buffer; whisper's non-causal
    # encoder (1500 keys: a tail of 28 past the last 64-key tile) and its
    # cross-attention decode over 1500 keys; moonshot's MHA prefill
    (1, 10, 1, 300, 300, 256, True, 64, None, 0, None),
    (2, 10, 1, 1, 512, 256, True, 64, None, 400, 401),
    (2, 4, 4, 1500, 1500, 64, False, None, None, 0, None),
    (4, 20, 20, 1, 1500, 64, False, None, None, 0, None),
    (1, 16, 16, 200, 256, 128, True, None, None, 0, 200),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap,q_offset,tk_valid", FA_CASES)
def test_flash_attention_kernel_matches_plain_version(card, B, Hq, Hkv, Tq, Tk, D, causal,
                                                      window, softcap, q_offset, tk_valid,
                                                      dtype):
    rng = np.random.default_rng(Tq * 1000 + Tk + D)
    q = torch.as_tensor(rng.standard_normal((B, Hq, Tq, D)) * 0.5, dtype=dtype, device=card)
    k = torch.as_tensor(rng.standard_normal((B, Hkv, Tk, D)) * 0.5, dtype=dtype, device=card)
    v = torch.as_tensor(rng.standard_normal((B, Hkv, Tk, D)), dtype=dtype, device=card)
    if tk_valid is not None:  # what lies beyond the valid prefix must never weigh in
        k[:, :, tk_valid:], v[:, :, tk_valid:] = torch.nan, torch.nan
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    before = flash_attention_cuda.launches
    out = flash_attention(q, k, v, tk_valid=tk_valid, **kw)
    valid = Tk if tk_valid is None else tk_valid
    ref = (attention_ref(q, k[:, :, :valid], v[:, :, :valid], **kw) if valid
           else torch.zeros_like(q))
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert out.shape == ref.shape and out.dtype == dtype and out.is_contiguous()
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_flash_attention_takes_strided_views(card):
    """The attention block hands the kernel einsum outputs: (B, T, H, D)
    buffers viewed as (B, H, T, D)."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((2, 9, 6, 16)), dtype=torch.float32,
                        device=card).transpose(1, 2)
    k = torch.as_tensor(rng.standard_normal((2, 9, 2, 16)), dtype=torch.float32,
                        device=card).transpose(1, 2)
    v = torch.as_tensor(rng.standard_normal((2, 9, 2, 16)), dtype=torch.float32,
                        device=card).transpose(1, 2)
    assert not q.is_contiguous()
    out = flash_attention_cuda(q, k, v, causal=True)
    ref = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=1.6e-4)


@pytest.mark.gpu
def test_flash_attention_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros((1, 4, 3, 8), device=card)
    kv = torch.zeros((1, 2, 5, 8), device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q.cpu(), kv, kv)
    with pytest.raises(ValueError, match="share one type"):
        flash_attention_cuda(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="share one type"):
        flash_attention_cuda(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 2, 3, 512), device=card)
        flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(torch.zeros((1, 3, 3, 8), device=card), kv, kv)
    with pytest.raises(ValueError, match="tk_valid"):
        flash_attention_cuda(q, kv, kv, tk_valid=6)
    with pytest.raises(ValueError, match="use_kernel=False"):
        flash_attention(q, kv, kv, use_kernel=False)
    assert flash_attention_cuda(q[:, :, :0], kv, kv).shape == (1, 4, 0, 8)


# --- K1's tensor-core design and K4's split-K decode -----------------------------

from repro_torch.kernels.coded_matmul.ref import coded_matmul_two_phase  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import split_plan  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("R,K,bm,ndim,degree", [(4, 2, 64, 384, None), (32, 8, 32, 200, 16)])
def test_cuda_kernel_at_k4096_matches_plain_version(card, R, K, bm, ndim, degree):
    """The 3xTF32 product at the main path's depth (k = 4096) keeps the fp32
    tolerance against the plain version and against its plain model."""
    code = fountain.make_lt_code(R=R, K=K, seed=R * 31 + K, parity_degree=degree)
    rng = np.random.default_rng(R + bm)
    a = torch.as_tensor(rng.standard_normal((R * bm, 4096)), dtype=torch.float32, device=card)
    x = torch.as_tensor(rng.standard_normal((4096, ndim)), dtype=torch.float32, device=card)
    idx, w = torch.as_tensor(code.idx, device=card), torch.as_tensor(code.weights, device=card)
    out = coded_matmul(a, x, idx, w, bm=bm)
    ref = coded_matmul_ref(a, x, idx, w, bm)
    model = coded_matmul_two_phase(a, x, idx, w, bm)
    torch.cuda.synchronize()
    tol = TOL[torch.float32] * (1.0 + float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol
    assert float((out - model).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["inf-direct", "inf-x", "nan-x", "pm1-systematic"])
def test_cuda_kernel_non_finite_and_signed_blocks_match_plain_version(card, case):
    """Outputs that meet an inf or a NaN come out of the tensor cores
    non-finite and are recomputed as plain fp32 dot products: inf for inf
    and NaN for NaN as in the plain version.  A systematic block of weight
    -1 goes through the prologue's encode."""
    R, K, bm, kdim, ndim = 6, 4, 8, 40, 24
    code = fountain.make_lt_code(R=R, K=K, seed=3)
    w = np.array(code.weights, copy=True)
    if case == "pm1-systematic":
        w[1, np.nonzero(w[1])[0][0]] = -1.0
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.standard_normal((R * bm, kdim)), dtype=torch.float32, device=card)
    x = torch.as_tensor(rng.standard_normal((kdim, ndim)), dtype=torch.float32, device=card)
    if case == "inf-direct":
        a[bm + 2, 7] = torch.inf
    if case == "inf-x":
        x[3, 5] = -torch.inf
    if case == "nan-x":
        x[11, 2] = torch.nan
    idx, wt = torch.as_tensor(code.idx, device=card), torch.as_tensor(w, device=card)
    out, ref = coded_matmul(a, x, idx, wt, bm=bm), coded_matmul_ref(a, x, idx, wt, bm)
    torch.cuda.synchronize()
    assert case == "pm1-systematic" or not bool(torch.isfinite(ref).all())
    fin = torch.isfinite(ref)
    tol = TOL[torch.float32] * (1.0 + float(ref[fin].abs().max()))
    torch.testing.assert_close(out, ref, rtol=0, atol=tol, equal_nan=True)


SPLIT_CASES = [  # (B, Hq, Hkv, Tq, Tk, D, q_offset, tk_valid, window, softcap)
    (4, 24, 8, 1, 2048, 128, 1040, 1041, None, None),   # the serving decode step
    (2, 6, 2, 1, 1024, 64, 49, 50, None, None),         # tk_valid in the first chunk
    (2, 6, 2, 1, 1024, 64, 255, 256, None, None),       # on a chunk edge
    (2, 6, 2, 1, 1024, 64, 1023, 1024, None, None),     # the whole buffer
    (2, 6, 2, 1, 1024, 64, 899, 900, 100, None),        # a window that empties chunks
    (2, 6, 2, 1, 1024, 64, 599, 600, None, 30.0),       # softcap
    (1, 6, 2, 5, 1024, 64, 700, 705, None, None),       # a short query block (wide tile)
    (1, 8, 2, 1, 700, 256, 650, 651, None, None),       # head dim 256 (one-stage tile)
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,q_offset,tk_valid,window,softcap", SPLIT_CASES)
def test_flash_attention_split_matches_plain_version(card, B, Hq, Hkv, Tq, Tk, D, q_offset,
                                                     tk_valid, window, softcap, dtype):
    """K4 with its keys split over more CTAs than the card has SMs (the
    split is asserted from the card's SM count), NaN in every slot beyond
    tk_valid, three launches in a row (the tickets go back to 0)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert split_plan(B, Hq, Hkv, Tq, Tk, D, sms).n_split > 1
    rng = np.random.default_rng(Tk + tk_valid + D)
    q = torch.as_tensor(rng.standard_normal((B, Hq, Tq, D)) * 0.5, dtype=dtype, device=card)
    k = torch.as_tensor(rng.standard_normal((B, Hkv, Tk, D)) * 0.5, dtype=dtype, device=card)
    v = torch.as_tensor(rng.standard_normal((B, Hkv, Tk, D)), dtype=dtype, device=card)
    k[:, :, tk_valid:], v[:, :, tk_valid:] = torch.nan, torch.nan
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    outs = [flash_attention(q, k, v, tk_valid=tk_valid, **kw) for _ in range(3)]
    ref = attention_ref(q, k[:, :, :tk_valid], v[:, :, :tk_valid], **kw)
    torch.cuda.synchronize()
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(outs[0].float(), ref.float(), rtol=rtol, atol=atol)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# --- K4's tensor-core instance (3xTF32 wgmma) and K2's raster ------------------

from repro_torch.kernels.flash_attention.ref import attention_3xtf32  # noqa: E402

# The FA_CASES that the tensor-core instance serves (float32, more than 8
# rows a KV head, D <= 128, aligned rows, no key split on a 132-SM card),
# then wgmma-specific shapes over many key tiles (enough CTAs that the keys
# are not split): phi4-mini's prefill at full size in a 2048-slot buffer,
# head dims 64 and 96 (a partial 32-column chunk and output half), a window
# and a softcap, non-causal with an offset, MHA; no row count fills whole
# 128-row tiles.
H100_SMS = 132
WG_CASES = [c for c in FA_CASES if split_plan(*c[:6], H100_SMS, True).wgmma] + [
    (4, 24, 8, 1023, 2048, 128, True, None, None, 0, 1023),
    (4, 24, 8, 300, 512, 64, True, None, None, 100, 400),
    (4, 16, 8, 200, 260, 96, True, None, None, 60, None),
    (4, 16, 8, 160, 300, 128, True, 100, None, 140, None),
    (4, 16, 8, 160, 192, 128, True, None, 30.0, 32, None),
    (4, 24, 8, 150, 200, 128, False, None, None, 50, 190),
    (4, 32, 32, 130, 130, 128, True, None, None, 0, None),
]


def _fa_inputs(card, B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((B, Hq, Tq, D)) * 0.5, dtype=torch.float32,
                        device=card)
    k = torch.as_tensor(rng.standard_normal((B, Hkv, Tk, D)) * 0.5, dtype=torch.float32,
                        device=card)
    v = torch.as_tensor(rng.standard_normal((B, Hkv, Tk, D)), dtype=torch.float32, device=card)
    return q, k, v


def _kernel_names(call) -> set:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if "flash_attention" in e.key}


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap,q_offset,tk_valid", WG_CASES)
def test_flash_attention_wgmma_matches_plain_version(card, B, Hq, Hkv, Tq, Tk, D, causal,
                                                     window, softcap, q_offset, tk_valid):
    """The tensor-core instance against the plain version within the fp32
    tolerance, NaN in every slot beyond tk_valid, and against its plain
    model (``ref.attention_3xtf32``) as closely."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert split_plan(B, Hq, Hkv, Tq, Tk, D, sms, True).wgmma
    q, k, v = _fa_inputs(card, B, Hq, Hkv, Tq, Tk, D, Tq * 1000 + Tk + D)
    valid = Tk if tk_valid is None else tk_valid
    k[:, :, valid:], v[:, :, valid:] = torch.nan, torch.nan
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    out = flash_attention(q, k, v, tk_valid=tk_valid, **kw)
    ref = (attention_ref(q, k[:, :, :valid], v[:, :, :valid], **kw) if valid
           else torch.zeros_like(q))
    model = attention_3xtf32(q, k, v, kv_len=valid, **kw)
    torch.cuda.synchronize()
    rtol, atol = FA_TOL[torch.float32]
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(out, model, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["nan-q", "inf-k", "-inf-k", "inf-v", "nan-v"])
def test_flash_attention_wgmma_non_finite_input_matches_plain_version(card, case):
    """An inf or a NaN in q, k or v.  The split turns an inf's small part
    into NaN; the kernel recomputes such scores and outputs in plain fp32,
    so it gives the plain version's result, NaN-equal: a NaN or +inf score
    makes its row's softmax NaN, which the plain version (and the kernel)
    write as a zero row; a -inf score weighs 0; an inf or a NaN in v makes
    its column inf or NaN."""
    B, Hq, Hkv, Tq, Tk, D = 1, 6, 2, 120, 120, 64
    q, k, v = _fa_inputs(card, B, Hq, Hkv, Tq, Tk, D, 17)
    clean = attention_ref(q, k, v, causal=True)
    if case == "nan-q":
        q[0, 1, 70, 5] = torch.nan
    if case in ("inf-k", "-inf-k"):  # key 2: q's column 7 decides the score's sign
        q[0, :3, :, 7] = q[0, :3, :, 7].abs()
        k[0, 0, 2, 7] = torch.inf if case == "inf-k" else -torch.inf
    if case == "inf-v":  # key 0, which every row sees
        v[0, 1, 0, 1] = torch.inf
    if case == "nan-v":
        v[0, 0, 3, 2] = torch.nan
    assert split_plan(B, Hq, Hkv, Tq, Tk, D, H100_SMS, True).wgmma
    out = flash_attention(q, k, v, causal=True)
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    if case in ("inf-v", "nan-v"):
        assert not bool(torch.isfinite(ref).all()) and bool(torch.isfinite(ref).any())
    elif case == "-inf-k":
        assert bool(torch.isfinite(ref).all()) and not torch.allclose(ref, clean)
    else:  # rows whose softmax met a NaN come out zero
        zero = (ref == 0).all(dim=-1)
        assert bool(zero.any()) and not bool((clean == 0).all(dim=-1).any())
    rtol, atol = FA_TOL[torch.float32]
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.gpu
def test_flash_attention_dispatch_takes_the_tensor_cores_for_float32_prefill(card):
    """More than 8 rows a KV head at D <= 128 in float32 runs the wgmma
    instance; a decode step, bfloat16, D = 256 and unaligned rows do not."""
    q, k, v = _fa_inputs(card, 2, 24, 8, 100, 128, 128, 3)
    names = _kernel_names(lambda: flash_attention_cuda(q, k, v))
    assert names and all("flash_attention_wgmma_kernel" in n for n in names)
    qd = q[:, :, :1].contiguous()
    names = _kernel_names(lambda: flash_attention_cuda(qd, k, v, q_offset=127))
    assert names and not any("wgmma" in n for n in names)
    names = _kernel_names(lambda: flash_attention_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16()))
    assert names and not any("wgmma" in n for n in names)
    q2, k2, v2 = _fa_inputs(card, 1, 4, 4, 40, 40, 256, 4)
    names = _kernel_names(lambda: flash_attention_cuda(q2, k2, v2))
    assert names and not any("wgmma" in n for n in names)
    q3, k3, v3 = _fa_inputs(card, 1, 4, 4, 40, 40, 18, 5)  # D = 18: rows are not 16-byte aligned
    names = _kernel_names(lambda: flash_attention_cuda(q3, k3, v3))
    assert names and not any("wgmma" in n for n in names)


# The rateless path's two shapes (R 64, bm 256, cols 4096 and R 256, bm 64,
# cols 8192) cut to 8 source blocks, K2 on the decoder's code.
K2_SHAPES = [(8, 8, 256, 4096), (8, 8, 64, 8192)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["aligned", "ragged", "unaligned", "nonfinite", "bf16"])
@pytest.mark.parametrize("R,K,bm,cols", K2_SHAPES)
def test_lt_encode_at_the_rateless_shapes_matches_plain_version(card, R, K, bm, cols, layout):
    """K2 with the coded blocks fastest in its grid, at the rateless path's
    widths: aligned rows, ragged columns, a source that starts one element
    past a 16-byte boundary (the element-wise loop), and an inf and a NaN in
    source block 0, which the decoder code's padding slots name (NaN rows),
    compared NaN-equal."""
    code = dec_pt.make_decoder_code(R, K)
    assert (code.weights == 0).any()
    dtype = torch.bfloat16 if layout == "bf16" else torch.float32
    c = cols - 3 if layout == "ragged" else cols
    rng = np.random.default_rng(R + bm)
    flat = torch.as_tensor(rng.standard_normal(R * bm * c + 1), dtype=dtype, device=card)
    a = (flat[1:] if layout == "unaligned" else flat[:-1]).view(R * bm, c)
    if layout == "nonfinite":
        a[3, 1], a[bm - 1, 0] = torch.inf, torch.nan
    idx, w = torch.as_tensor(code.idx, device=card), torch.as_tensor(code.weights, device=card)
    out = lt_encode(a, idx, w, bm=bm)
    ref = lt_encode_ref(a, idx, w, bm)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert (layout == "nonfinite") == (not bool(torch.isfinite(ref).all()))
    finite = ref.float()[torch.isfinite(ref)].abs().max()
    tol = TOL[dtype] * (1.0 + float(finite))
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol, equal_nan=True)


# --- K3: one launch per peeling plan ---------------------------------------------

from repro_torch.core import coded_matmul as cm  # noqa: E402
from repro_torch.kernels.lt_decode import (lt_decode_program_ref, plan_program,  # noqa: E402
                                           schedule)


def _decode_inputs(card, R, K, bm, cols, dtype, lost, d_max=8):
    code = dec_pt.make_decoder_code(R, K, seed=R + K, d_max=d_max)
    x = torch.as_tensor(np.random.default_rng(R + cols).standard_normal((R * bm, cols)),
                        dtype=dtype, device=card)
    coded = lt_encode_ref(x, torch.as_tensor(code.idx, device=card),
                          torch.as_tensor(code.weights, device=card), bm)
    keep = np.setdiff1d(np.arange(R + K), lost)
    plan = fountain.peel_decode_plan(code, keep)
    crx = coded.reshape(R + K, bm, cols)[torch.as_tensor(keep, device=card)]
    return code, keep, plan, x, crx.reshape(-1, cols).contiguous()


def _nan_equal(out, ref, dtype):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    fin = torch.isfinite(ref)
    tol = TOL[dtype] * (1.0 + (float(ref.float()[fin].abs().max()) if bool(fin.any()) else 0.0))
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol, equal_nan=True)


def _block0_case(R, K):
    """A loss set where block 0 is recovered in a round r that also recovers
    other entries naming block 0 in padding slots, and a later round has
    such entries too."""
    code = dec_pt.make_decoder_code(R, K, seed=R + K, d_max=8)
    for n in range(2, R // 2 + 1):
        for seed in range(50):
            lost = np.unique(np.r_[0, np.random.default_rng(n + seed).choice(R, n, replace=False)])
            plan = fountain.peel_decode_plan(code, np.setdiff1d(np.arange(R + K), lost))
            if plan is None:
                continue
            rounds = fountain.plan_rounds(plan)
            r0 = next(i for i, r in enumerate(rounds) if 0 in r.src)
            if (rounds[r0].size > 1 and (rounds[r0].nbr_coef == 0).any()
                    and any((r.nbr_coef == 0).any() for r in rounds[r0 + 1:])):
                return lost, r0
    raise AssertionError(f"no block-0 loss pattern at R{R}K{K}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,K,bm,cols", [(20, 24, 8, 16), (24, 30, 5, 77)])
def test_lt_decode_block0_recovered_non_finite_in_a_round(card, R, K, bm, cols, dtype):
    """Block 0 lost and recovered non-finite in round r: round r's other
    entries read it as the zeros it was before the round (finite), later
    rounds' padding slots turn it into NaN, as in the plain version."""
    lost, r0 = _block0_case(R, K)
    _code, _keep, plan, _x, crx = _decode_inputs(card, R, K, bm, cols, dtype, lost)
    rounds = fountain.plan_rounds(plan)
    cpos = int(rounds[r0].coded[list(rounds[r0].src).index(0)])
    crx[cpos * bm + bm - 1, cols - 1] = torch.inf
    before = lt_decode_plan_cuda.launches
    out = lt_decode(crx, plan, bm=bm)
    ref = lt_decode_ref(crx, plan, bm=bm)
    torch.cuda.synchronize()
    assert lt_decode_plan_cuda.launches == before + 1
    at = ref.view(R, bm, cols)[:, bm - 1, cols - 1]
    assert all(bool(torch.isfinite(at[int(s)])) for s in rounds[r0].src if s != 0)
    assert any(bool(torch.isnan(at[int(s)])) for r in rounds[r0 + 1:] for s in r.src)
    _nan_equal(out, ref, dtype)


@pytest.mark.gpu
def test_lt_decode_plan_larger_than_a_chunk(card):
    """A plan whose program spans several shared-memory chunks: 2048
    sources, 700 lost (8392 words, three chunks), through lt_decode and
    through the plan wrapper against the program's plain version."""
    R, K, bm, cols = 2048, 2048, 2, 12
    lost = np.random.default_rng(0).choice(R, size=700, replace=False)
    _code, keep, plan, x, crx = _decode_inputs(card, R, K, bm, cols, torch.float32, lost,
                                               d_max=16)
    assert plan is not None
    words = plan_program(plan, len(keep))
    assert words.size > 2 * schedule.CHUNK_WORDS
    ref = lt_decode_ref(crx, plan, bm=bm)
    before = lt_decode_plan_cuda.launches
    out = lt_decode(crx, plan, bm=bm)
    torch.cuda.synchronize()
    assert lt_decode_plan_cuda.launches == before + 1
    torch.testing.assert_close(out, x, rtol=1e-4, atol=1e-4)
    _nan_equal(out, ref, torch.float32)
    src = ref.clone()
    src.view(R, bm, cols)[torch.as_tensor(plan.order_src, device=card).long()] = torch.nan
    plain = lt_decode_program_ref(crx, src.clone(), words, bm=bm)
    out = lt_decode_plan_cuda(crx, src, torch.as_tensor(words, device=card), bm)
    torch.cuda.synchronize()
    _nan_equal(out, plain, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["unaligned", "ragged", "bf16-unaligned", "all-skipped"])
def test_lt_decode_plan_layouts(card, layout):
    """A coded buffer one element past a 16-byte boundary and blocks whose
    length is no multiple of the vector (the element-wise loop), and a
    program whose entries are all skipped (src untouched)."""
    dtype = torch.bfloat16 if layout.startswith("bf16") else torch.float32
    R, K, bm, cols = 20, 24, 8, (15 if layout == "ragged" else 16)
    lost = np.random.default_rng(6).choice(R, size=6, replace=False)
    _code, keep, plan, _x, crx = _decode_inputs(card, R, K, bm, cols, dtype, lost)
    if layout.endswith("unaligned"):
        buf = torch.empty(crx.numel() + 1, dtype=dtype, device=card)
        buf[1:] = crx.reshape(-1)
        crx = buf[1:].view(-1, cols)
    ref = lt_decode_ref(crx, plan, bm=bm)
    if layout == "all-skipped":
        words = schedule.round_program(np.full(3, -1), plan.order_src[:3], plan.order_nbr_idx[:3],
                                       plan.order_nbr_coef[:3], np.ones(3, np.float32), R=R,
                                       n_rx=len(keep))
        assert words.size > 0
        before = lt_decode_plan_cuda.launches
        out = lt_decode_plan_cuda(crx, ref.clone(), torch.as_tensor(words, device=card), bm)
        torch.cuda.synchronize()
        assert lt_decode_plan_cuda.launches == before + 1 and torch.equal(out, ref)
        return
    out = lt_decode(crx, plan, bm=bm)
    torch.cuda.synchronize()
    _nan_equal(out, ref, dtype)


def _scan_block0_case(R, K):
    """A loss set where block 0 is recovered at step t0 and a later step of
    the same round names block 0 in a padding slot: plan order (the
    reference's scan) gives it NaN when block 0 is non-finite, the rounds
    would not."""
    code = dec_pt.make_decoder_code(R, K, seed=R + K, d_max=8)
    for n in range(2, R // 2 + 1):
        for seed in range(50):
            lost = np.unique(np.r_[0, np.random.default_rng(n + seed).choice(R, n, replace=False)])
            plan = fountain.peel_decode_plan(code, np.setdiff1d(np.arange(R + K), lost))
            if plan is None:
                continue
            t0 = list(plan.order_src).index(0)
            step = fountain.plan_step_rounds(plan)
            pads0 = ((plan.order_nbr_coef == 0) & (plan.order_nbr_idx == 0)).any(axis=1)
            if (pads0[t0 + 1:] & (step[t0 + 1:] == step[t0])).any():
                return lost
    raise AssertionError(f"no same-round block-0 loss pattern at R{R}K{K}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["block0-recovered-inf", "received-block0-nan"])
def test_fountain_decode_on_the_card_matches_the_cpu_route_on_non_finite_blocks(card, case):
    """fountain.decode's peel on the card (K3 on the plan's steps in plan
    order) against the CPU route (apply_decode_plan, the reference's scan),
    NaN-equal: block 0 lost and recovered as inf, which a later step of its
    own round reads through a padding slot (NaN); or received block 0
    holding a NaN."""
    R, K, bm, cols = 20, 24, 8, 16
    if case == "block0-recovered-inf":
        lost = _scan_block0_case(R, K)
    else:
        lost = np.random.default_rng(6).choice(np.arange(1, R), size=6, replace=False)
    code, keep, plan, _x, crx = _decode_inputs(card, R, K, bm, cols, torch.float32, lost)
    rx = crx.view(len(keep), bm, cols)
    if case == "block0-recovered-inf":
        rx[int(plan.order_coded[list(plan.order_src).index(0)]), bm - 1, cols - 1] = torch.inf
    else:
        rx[int(plan.direct_coded[list(plan.direct_src).index(0)]), 0, 0] = torch.nan
    before = lt_decode_plan_cuda.launches
    out, method = fountain.decode(rx, code, keep)
    torch.cuda.synchronize()
    assert method == "peel" and lt_decode_plan_cuda.launches == before + 1
    cpu, _ = fountain.decode(rx.cpu(), code, keep)
    assert not bool(torch.isfinite(cpu).all())
    _nan_equal(out.cpu(), cpu, torch.float32)


@pytest.mark.gpu
def test_fountain_decode_and_recover_on_the_card_match_the_cpu_route(card):
    """The collector's recovery on CUDA tensors (peel on K3, one launch per
    peeling loss; the dense solve unchanged) against the CPU route
    (apply_decode_plan), for every single-shard loss of a small plan."""
    plan = cm.plan_coded_matmul(rows=512, n_shards=8, overhead=0.25, bm=16)
    gen = torch.Generator().manual_seed(0)
    a, x = torch.randn((512, 96), generator=gen), torch.randn((96, 40), generator=gen)
    out_cpu = cm.run(plan, a, x)
    out = out_cpu.to(card)
    methods = []
    for lost in range(plan.placement.shape[0]):
        survivors = np.delete(np.arange(plan.placement.shape[0]), lost)
        ids = np.concatenate([plan.placement[s] for s in survivors])
        before = lt_decode_plan_cuda.launches
        y = cm.recover(plan, out, survivors)
        torch.cuda.synchronize()
        peel = fountain.peel_decode_plan(plan.code, ids)
        methods.append("dense" if peel is None else "peel")
        peeled = peel is not None and peel.n_peeled > 0
        assert lt_decode_plan_cuda.launches == before + int(peeled)
        torch.testing.assert_close(y.cpu(), cm.recover(plan, out_cpu, survivors),
                                   rtol=1e-4, atol=1e-4)
    assert "peel" in methods
    rx = out.view(-1, plan.bm, 40)[:plan.blocks_per_shard * 7]
    ids = np.concatenate([plan.placement[s] for s in range(7)])
    if fountain.peel_decode_plan(plan.code, ids) is not None:
        with pytest.raises(ValueError, match="takes"):
            fountain.decode(rx.double(), plan.code, ids)


# The block baselines' control plane: no kernel of its own, but its loads
# come from sums and a float32 Newton solve whose bits must not depend on
# the device (one ulp can move a largest-remainder tie).
from repro_torch.configs.ccp_paper import FIG3, FIG4  # noqa: E402
from repro_torch.core import engine as eng_pt  # noqa: E402
from repro_torch.core import simulator as sim_pt  # noqa: E402
from repro_torch.core.policies import hcmm as hcmm_pt  # noqa: E402
from repro_torch.core.policies import uncoded as uncoded_pt  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["uncoded_mean", "uncoded_mu", "hcmm"])
@pytest.mark.parametrize("N,scenario", [(20, 1), (20, 2), (100, 1)])
def test_block_policy_on_the_card_equals_the_cpu(card, policy, N, scenario):
    """One set of tables through ``simulate`` on the card and on the CPU:
    loads bitwise, T at rtol 1e-6, r_n and valid equal."""
    cfg, R = sim_pt.ScenarioConfig(N=N, scenario=scenario), 400 if N == 20 else 2000
    tables = eng_pt.draw_tables(torch.Generator().manual_seed(N + scenario), cfg, 8, R, 128)
    on_card = tables.to(card)
    cpu = eng_pt.simulate(tables, cfg, R, policy)
    gpu = eng_pt.simulate(on_card, cfg, R, policy)
    assert torch.equal(gpu["x_loads"].cpu(), cpu["x_loads"])
    torch.testing.assert_close(gpu["T"].cpu(), cpu["T"], rtol=1e-6, atol=0)
    torch.testing.assert_close(gpu["efficiency"].cpu(), cpu["efficiency"], rtol=1e-6,
                               atol=1e-7, equal_nan=True)
    for k in ("r_n", "valid"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [FIG3[1], FIG4[1]], ids=["fig3", "fig4"])
@pytest.mark.parametrize("R", [1000, 2000, 4000, 8000])
def test_block_allocations_on_the_card_equal_the_cpu(card, cfg, R):
    """The figures' helper draws (N=100, 200 reps): the ordered sum, HCMM's
    Newton root and every policy's loads are bitwise the CPU's."""
    mu, a, _rate = sim_pt.draw_helpers(torch.Generator().manual_seed(R), cfg, 200)
    assert torch.equal(uncoded_pt.ordered_sum(mu.to(card)).cpu(), uncoded_pt.ordered_sum(mu))
    assert torch.equal(hcmm_pt.u_star((mu * a).to(card)).cpu(), hcmm_pt.u_star(mu * a))
    assert torch.equal(hcmm_pt.hcmm_loads(R, mu.to(card), a.to(card)).cpu(),
                       hcmm_pt.hcmm_loads(R, mu, a))
    for rule in ("mean", "mu"):
        pol = uncoded_pt.UncodedPolicy(rule=rule)
        assert torch.equal(pol.prepare(cfg, R, None, mu.to(card), a.to(card), None)["loads"].cpu(),
                           pol.prepare(cfg, R, None, mu, a, None)["loads"])


# The churn branch of the engine: no kernel of its own; the card's loop
# must lose, resend and complete exactly as the CPU's on the same tables.
CHURN_POLICIES = ["ccp", "best", "naive", "naive_oracle", "uncoded_mean", "uncoded_mu",
                  "hcmm", "rateless_ccp", "adaptive_rate", "adaptive_rate_fb"]


def _golden_churn_cfg(N=16):
    """The churn golden's config (tests/test_policies.py): lognormal
    outages, slowdowns, i.i.d. drop, Gilbert–Elliott and cell outages."""
    return sim_pt.ScenarioConfig(N=N, scenario=1, churn=sim_pt.ChurnConfig(
        period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05, ge_p_bad=0.02, ge_p_good=0.2,
        ge_loss_bad=0.5, p_cell=0.1, cell_frac=0.5, outage_dist="lognormal",
        outage_mean=4.0, outage_sigma=0.5, max_backoff=8.0))


@pytest.mark.gpu
@pytest.mark.parametrize("policy", CHURN_POLICIES)
def test_churn_engine_on_the_card_equals_the_cpu(card, policy):
    """One set of churn tables through the loop and ``simulate`` on the
    card and on the CPU: the lost, tx and tr traces, T, r_n, valid,
    max_backoff and lost_frac bit for bit; efficiency at rtol 1e-6 (its
    sums over M run in another order)."""
    cfg, R, M = _golden_churn_cfg(), 200, 840
    tables = eng_pt.draw_tables(torch.Generator().manual_seed(1), cfg, 4, R, M)
    on_card = tables.to(card)
    c = cfg.ccp_cfg(R)
    pol = eng_pt._as_policy(policy)
    traces = [eng_pt.policy_stream(
        t.beta, t.d_up, t.d_ack, t.d_down, policy=pol, cfg_static=(c.Bx, c.Br, c.Back, c.alpha),
        churn_static=cfg.churn.static_key(), dyn=t.dyn, a=t.a,
        aux=pol.prepare(cfg, R, c, t.mu, t.a, t.rate))[0] for t in (tables, on_card)]
    for k in ("lost", "tx", "tr", "tx_end"):
        assert torch.equal(traces[1][k].cpu(), traces[0][k]), k
    cpu = eng_pt.simulate(tables, cfg, R, policy)
    gpu = eng_pt.simulate(on_card, cfg, R, policy)
    for k in ("T", "r_n", "valid", "max_backoff", "lost_frac"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    torch.testing.assert_close(gpu["efficiency"].cpu(), cpu["efficiency"], rtol=1e-6,
                               atol=1e-7, equal_nan=True)
    assert bool(cpu["lost_frac"].gt(0).any())


@pytest.mark.gpu
def test_churn_figures_smoke_on_the_card(card, tmp_path):
    """``fig_churn`` and ``fig_decode`` in their smoke sizes on the card:
    every policy column, the card's name in the artifact's meta."""
    import json

    from repro_torch.figures import run as figures_run

    out = figures_run.main(["--smoke", "--only", "fig_churn,fig_decode", "--out", str(tmp_path)])
    assert set(out) == {"fig_churn", "fig_decode"}
    for name in out:
        doc = json.loads((tmp_path / f"{name}.json").read_text())
        assert doc["meta"]["device"]["type"] == "cuda" and doc["meta"]["device"]["nvidia_smi"]
        assert doc["data"]


# The transport line and the fleet loop: no kernel of their own; the card's
# loops must observe, queue and complete exactly as the CPU's.
from repro_torch.core import fleet as fleet_pt  # noqa: E402
from repro_torch.core import policies as pol_pt  # noqa: E402


def _transport_cfg(N, rtt_mean):
    """tests/test_transport.py's churn mix under log-normal feedback RTT."""
    return sim_pt.ScenarioConfig(N=N, scenario=1, churn=sim_pt.ChurnConfig(
        period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05, ge_p_bad=0.03, ge_p_good=0.25,
        ge_loss_bad=0.5, p_cell=0.05, cell_frac=0.5, max_backoff=8.0,
        rtt_dist="lognormal", rtt_mean=rtt_mean))


def _card_equals_cpu(gpu: dict, cpu: dict, close=()):
    for k, c in cpu.items():
        g = gpu[k].cpu()
        if k in close:
            torch.testing.assert_close(g, c, rtol=1e-6, atol=1e-7, equal_nan=True)
        else:
            same = (g == c) | (g.isnan() & c.isnan()) if c.is_floating_point() else g == c
            assert g.dtype == c.dtype and bool(same.all()), k


@pytest.mark.gpu
@pytest.mark.parametrize("policy", sorted(pol_pt.names()))
def test_transport_engine_on_the_card_equals_the_cpu(card, policy):
    """One set of transport tables through ``simulate`` on the card and on
    the CPU: every output bit for bit but the efficiency (rtol 1e-6)."""
    cfg, R = _transport_cfg(16, 2.0), 60
    tables = eng_pt.draw_tables(torch.Generator().manual_seed(2), cfg, 4, R, 252)
    cpu = eng_pt.simulate(tables, cfg, R, policy)
    _card_equals_cpu(eng_pt.simulate(tables.to(card), cfg, R, policy), cpu, close=("efficiency",))
    assert bool(cpu["lost_frac"].gt(0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("discipline", fleet_pt.DISCIPLINES)
@pytest.mark.parametrize("policy", ["ccp", "tfrc_ccp", "rateless_ccp", "hcmm"])
def test_fleet_on_the_card_equals_the_cpu(card, policy, discipline):
    """One set of fleet tables (3 tenants, striped over 12 helpers, 6 each)
    under churn and transport through ``simulate_fleet`` on the card and on
    the CPU: every output bit for bit but efficiency and utilization."""
    cfg, R = _transport_cfg(12, 1.0), 60
    fc = fleet_pt.FleetConfig(n_tasks=3, discipline=discipline, placement="striped",
                              helpers_per_task=6)
    tables = eng_pt.draw_fleet_tables(torch.Generator().manual_seed(4), cfg, fc, 4, R, 128)
    cpu = eng_pt.simulate_fleet(tables, cfg, R, policy, fc)
    gpu = eng_pt.simulate_fleet(tables.to(card), cfg, R, policy, fc)
    _card_equals_cpu(gpu, cpu, close=("efficiency", "util"))


@pytest.mark.gpu
def test_transport_and_fleet_figures_smoke_on_the_card(card, tmp_path):
    import json

    from repro_torch.figures import run as figures_run

    out = figures_run.main(["--smoke", "--only", "fig_transport,fig_fleet", "--out",
                            str(tmp_path)])
    assert set(out) == {"fig_transport", "fig_fleet"}
    for name in out:
        doc = json.loads((tmp_path / f"{name}.json").read_text())
        assert doc["meta"]["device"]["type"] == "cuda" and doc["data"]


# --- LM training: K4's backward, the train step, the attention gradients --------

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.autograd import kernel_forward  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (attention_bwd_3xtf32,  # noqa: E402
                                                     attention_bwd_ref, attention_fwd_ref)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402

# chip_smoke.py's [k4-bwd-check] cases: (B, Hq, Hkv, Tq, Tk, D, causal,
# window, softcap, q_offset, tk_valid, the instance float32 runs: "wgmma"
# for the tensor cores, "cuda-cores"; bfloat16 always runs the CUDA cores),
# and its limits for the gradients,
# |d - ref| <= atol max|ref| + rtol |ref|: float32 the forward's; bfloat16
# rtol 2e-2 (2.5 ulp of the one rounding each side makes) and atol 1e-3,
# tighter than the forward's 0.16, which would pass late keys' dK and dV
# written as zeros under a causal mask.
FA_BWD_TOL = {torch.float32: FA_TOL[torch.float32], torch.bfloat16: (2e-2, 1e-3)}
FA_BWD_CASES = [
    (1, 2, 2, 64, 64, 64, True, None, None, 0, None, "wgmma"),
    (2, 6, 2, 100, 100, 128, True, None, None, 0, None, "wgmma"),  # 300 rows: ragged
    (1, 8, 2, 37, 53, 128, False, None, None, 0, None, "wgmma"),
    (1, 4, 2, 96, 96, 64, True, 16, None, 0, None, "wgmma"),
    (1, 4, 1, 80, 80, 64, True, None, 30.0, 0, None, "wgmma"),
    (2, 4, 2, 45, 45, 24, True, 8, 50.0, 0, None, "wgmma"),
    (2, 6, 2, 23, 64, 24, True, None, None, 10, 33, "wgmma"),
    (1, 4, 2, 16, 32, 64, True, None, None, -3, None, "wgmma"),
    (1, 4, 2, 5, 40, 8, True, None, None, 3, 0, "wgmma"),
    (1, 4, 4, 70, 200, 256, True, 32, None, 5, 75, "cuda-cores"),
    (1, 24, 8, 256, 256, 128, True, None, None, 0, None, "wgmma"),
    (2, 6, 2, 70, 160, 128, True, None, None, 40, 101, "wgmma"),  # tk_valid inside a tile
    (1, 4, 2, 50, 50, 30, True, None, None, 0, None, "cuda-cores"),  # rows unaligned
    (1, 10, 1, 256, 256, 256, True, 64, None, 0, None, "cuda-cores"),  # recurrentgemma's heads
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap,q_offset,tk_valid,instance",
                         FA_BWD_CASES)
def test_flash_attention_backward_kernel_matches_plain_version(
        card, B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset, tk_valid, instance,
        dtype):
    """The backward kernel against ``attention_bwd_ref`` over the valid
    prefix (what lies beyond it is NaN and gets exact zero gradients), each
    gradient within FA_BWD_TOL, on the instance the case names for float32
    (``bwd_plan``), the tensor-core instance also against the plain model
    of its arithmetic (``attention_bwd_3xtf32``); the forward's lse against
    the plain one within FA_TOL; two runs bitwise equal."""
    plan = fa_kernel.bwd_plan(D, dtype == torch.float32 and D % 4 == 0)
    assert ("wgmma" if plan.wgmma else "cuda-cores") == (
        instance if dtype == torch.float32 else "cuda-cores")
    rng = np.random.default_rng(Tq * 1000 + Tk + D)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(s) * 0.5, dtype=dtype, device=card)
                   for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D), (B, Hq, Tq, D)))
    valid = Tk if tk_valid is None else tk_valid
    k[:, :, valid:], v[:, :, valid:] = torch.nan, torch.nan
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    out, lse = kernel_forward(q, k, v, kv_len=tk_valid, **kw)
    before = fa_kernel.flash_attention_bwd_cuda.launches
    grads = fa_kernel.flash_attention_bwd_cuda(q, k, v, out, do, lse, tk_valid=tk_valid, **kw)
    again = fa_kernel.flash_attention_bwd_cuda(q, k, v, out, do, lse, tk_valid=tk_valid, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_bwd_cuda.launches == before + 2 * fa_kernel.BWD_LAUNCHES
    o_ref, lse_ref = attention_fwd_ref(q, k[:, :, :valid], v[:, :, :valid], **kw)
    ref = attention_bwd_ref(q, k[:, :, :valid], v[:, :, :valid], o_ref, do, lse_ref, **kw)
    rtol, atol = FA_TOL[dtype]
    assert torch.equal(torch.isneginf(lse), torch.isneginf(lse_ref))
    fin = torch.isfinite(lse_ref)
    torch.testing.assert_close(lse[fin], lse_ref[fin], rtol=rtol, atol=atol)
    pad = torch.zeros((B, Hkv, Tk - valid, D), dtype=dtype, device=card)
    g_rtol, g_atol = FA_BWD_TOL[dtype]
    refs = [(ref[0], torch.cat([ref[1], pad], 2), torch.cat([ref[2], pad], 2))]
    if plan.wgmma:
        refs.append(attention_bwd_3xtf32(q, k, v, out, do, lse, kv_len=tk_valid, **kw))
    for want in refs:
        for g, r in zip(grads, want):
            assert g.shape == r.shape and g.dtype == dtype and bool(torch.isfinite(g).all())
            scale = float(r.float().abs().max())
            assert bool(((g.float() - r.float()).abs()
                         <= g_atol * scale + g_rtol * r.float().abs()).all())
    assert all(bool((g[:, :, valid:] == 0).all()) for g in grads[1:])
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
def test_tensor_core_attention_launches_from_a_thread_of_its_own(card):
    """K4's tensor-core forward and backward launched first in a fresh
    thread (autograd runs the backward, and recomputes a checkpointed
    forward, on a thread of its own) give what they give on the main
    thread, bit for bit: each launch makes the device's context current
    before it encodes its TMA maps."""
    import threading

    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v, do = (torch.randn(s, generator=gen, device=card)
                   for s in ((2, 6, 40, 32), (2, 2, 40, 32), (2, 2, 40, 32), (2, 6, 40, 32)))
    kw = dict(causal=True, window=16, softcap=20.0, q_offset=0)

    def run():
        out, lse = kernel_forward(q, k, v, kv_len=None, **kw)
        grads = fa_kernel.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        return (out, *grads)

    results = {}

    def in_thread():
        try:
            results["thread"] = run()
        except Exception as e:  # re-raised on the main thread below
            results["error"] = e

    worker = threading.Thread(target=in_thread)
    worker.start()
    worker.join()
    if "error" in results:
        raise results["error"]
    assert fa_kernel.bwd_plan(32, True).wgmma
    assert all(torch.equal(a, b) for a, b in zip(results["thread"], run()))


@pytest.mark.gpu
def test_flash_attention_on_the_card_gives_q_k_v_their_gradients(card):
    """The fault repaired: K4 on CUDA tensors that require grad, through the
    autograd function, and the gradients of the plain route."""
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=gen, device=card)
                   for s in ((2, 6, 40, 32), (2, 2, 40, 32), (2, 2, 40, 32), (2, 6, 40, 32)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, window=16, softcap=20.0).backward(do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    attention_ref(*plain, window=16, softcap=20.0).backward(do)
    for a, b in zip(leaves, plain):
        assert a.grad is not None and bool(a.grad.abs().max() > 0)
        torch.testing.assert_close(a.grad, b.grad, rtol=2e-5, atol=1.6e-4)


@pytest.mark.gpu
def test_every_attention_weight_gets_a_gradient_on_the_card(card):
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = build_model(cfg, remat=True)
    params = model.init(0, device=card)
    tok = torch.randint(0, cfg.vocab, (2, 24), device=card)
    _, grads = train_loop.value_and_grad(model.loss_fn, params, {"tokens": tok, "labels": tok})
    for block in grads["blocks"]:
        for name in ("wq", "wk", "wv", "wo"):
            g = block["mixer"][name]
            assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), name


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma2-27b"])
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    """One smoke train step (2 microbatches) with the same weights on the
    card and on the CPU: the loss within 1e-5 relative, each gradient leaf
    within 1e-4 of its max |.|, and the step's metrics."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, remat=True)
    on_cpu = model.init(0, device="cpu")
    on_card = tree_map(lambda p: p.to(card), on_cpu)
    tok = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 4, 16)).astype(np.int32)
    runs = []
    for params, dev in ((on_card, card), (on_cpu, torch.device("cpu"))):
        micro = {"tokens": torch.as_tensor(tok, device=dev),
                 "labels": torch.as_tensor(tok[..., ::-1].copy(), device=dev)}
        runs.append(train_loop.accumulate_grads(model, params, micro))
    (g_card, l_card), (g_cpu, l_cpu) = runs
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu))
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    metrics = []
    for params, dev in ((on_card, card), (on_cpu, "cpu")):
        step = train_loop.make_train_step(model, opt_cfg, 2, pre_shaped=True, device=dev)
        _, state, m = step(params, adamw.init(params), {"tokens": tok, "labels": tok})
        metrics.append(m)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[0][key]), float(metrics[1][key]), rtol=1e-5)


FAMILIES = ["recurrentgemma-2b", "xlstm-350m", "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
            "whisper-large-v3"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_smoke_model_on_the_card_matches_the_cpu(card, arch):
    """Slice C3's families at their smoke configs with the same weights on
    the card (K4 and its backward, cuBLAS) and on the CPU (the plain
    versions): the forward's logits, a prefill and teacher-forced decode
    within 1e-4, and the loss within 1e-5 relative and each gradient leaf
    within 1e-4 of its max |.|."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    on_cpu = model.init(0, device="cpu")
    on_card = tree_map(lambda p: p.to(card), on_cpu)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    frames = (rng.standard_normal((2, cfg.enc_frames, cfg.d_model)).astype(np.float32) * 0.02
              if cfg.enc_dec else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for params, dev in ((on_card, card), (on_cpu, torch.device("cpu"))):
        emb = None if frames is None else torch.as_tensor(frames, device=dev)
        t = torch.as_tensor(tok, device=dev)
        with torch.no_grad():
            logits = [model.forward(params, t, emb)[:, -1]]
            cache = model.init_cache(2, 16, device=dev)
            step, cache = model.prefill(params, t[:, :8], cache, emb)
            logits.append(step)
            for i in range(8, 12):
                step, cache = model.decode_step(params, t[:, i:i + 1], cache)
                logits.append(step)
        loss, grads = train_loop.value_and_grad(
            model.loss_fn, params, {"tokens": t[:, :-1], "labels": t[:, 1:], "embeds": emb})
        runs.append(([x.cpu() for x in logits], float(loss),
                     [g.cpu() for g in tree_leaves(grads)]))
    (lg_card, l_card, g_card), (lg_cpu, l_cpu, g_cpu) = runs
    for a, b in zip(lg_card, lg_cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    top = max(float(b.abs().max()) for b in g_cpu)
    for a, b in zip(g_card, g_cpu):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= max(1e-4 * float(b.abs().max()), 1e-6 * top)


@pytest.mark.gpu
def test_moe_combine_on_the_card_is_bitwise_repeatable(card):
    """The MoE block on the card, at moonshot's smoke width with tokens
    dropped at capacity: two runs bitwise equal (the combine reads each
    token's slots and sums in a fixed order, no atomics), and within 1e-5
    of the CPU."""
    import dataclasses

    from repro_torch.models import moe

    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    from repro_torch.models.common import ParamBuilder
    params = moe.init_moe(ParamBuilder(torch.Generator().manual_seed(0)), cfg)
    x = torch.randn((8, 64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = {k: v.to(card) for k, v in params.items()}
    a, aux_a = moe.moe_block(on_card, x.to(card), cfg)
    b, aux_b = moe.moe_block(on_card, x.to(card), cfg)
    ref, aux_ref = moe.moe_block(params, x, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    torch.testing.assert_close(a.cpu(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux_a.cpu(), aux_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_checkpoint_restores_into_card_tensors_and_onto_the_card(card, tmp_path):
    """A tree on the card (a bf16 leaf and AdamW's step among float32 ones)
    saved and restored: into the same card tensors (copied into, the same
    objects), and from a meta target onto the card by ``device``."""
    from repro_torch import checkpoint as ck
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw

    g = torch.Generator(device=card).manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=g, device=card),
              "b": torch.randn(32, generator=g, device=card).bfloat16()}
    state = adamw.AdamWState(5, {k: v.float() * 2 for k, v in params.items()},
                             {k: v.float() ** 2 for k, v in params.items()})
    tree = {"params": params, "opt": state}
    ck.save(tmp_path, 5, tree, metadata={"step": 5})
    want = [t.clone() for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t.zero_()
    r, meta = ck.restore(tmp_path, None, tree)
    assert meta == {"step": 5} and r["opt"].step == 5 and r["params"]["w"] is params["w"]
    got = [t for t in tree_leaves(r) if isinstance(t, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    meta_tree = {"params": {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                            for k, v in params.items()},
                 "opt": adamw.AdamWState(0, *({k: torch.empty(v.shape, device="meta")
                                               for k, v in s.items()}
                                              for s in (state.m, state.v)))}
    r, _ = ck.restore(tmp_path, 5, meta_tree, device=card)
    got = [t for t in tree_leaves(r) if isinstance(t, torch.Tensor)]
    assert all(t.device.type == "cuda" and torch.equal(a, t) for a, t in zip(want, got))


@pytest.mark.gpu
def test_step_costs_count_the_kernels_launches_on_the_card(card):
    """Under StepCosts, K4's forward and backward add their bound's counts
    (the wrappers are ctypes launches the dispatcher never sees)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.utils.trace import StepCosts

    g = torch.Generator(device=card).manual_seed(1)
    B, Hq, Hkv, T, D = 2, 4, 2, 96, 64
    q = torch.randn((B, Hq, T, D), generator=g, device=card, requires_grad=True)
    k, v = (torch.randn((B, Hkv, T, D), generator=g, device=card, requires_grad=True)
            for _ in range(2))
    with StepCosts() as costs:
        out = flash_attention(q, k, v, causal=True)
        out.sum().backward()
        torch.cuda.synchronize()
    kw = dict(q_offset=0, tk_valid=T, causal=True, window=None, elem=4)
    f, b = k4.attention_costs(B, Hq, Hkv, T, D, lse=True, **kw)
    fb, bb = k4.attention_bwd_costs(B, Hq, Hkv, T, T, D, **kw)
    assert costs.by_kernel["flash_attention"] == {"calls": 1, "flops": f, "bytes": b}
    assert costs.by_kernel["flash_attention_bwd"] == {"calls": 1, "flops": fb, "bytes": bb}
    assert costs.kernel_flops == f + fb and costs.aten_bytes > 0
