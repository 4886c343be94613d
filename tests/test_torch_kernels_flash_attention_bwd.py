"""K4's backward on the tensor cores, on the CPU: the plain model of its
arithmetic (``ref.attention_bwd_3xtf32``: the kernel's tiles, every product
3xTF32) against the plain backward ``ref.attention_bwd_ref`` and ``jax.vjp``
of the reference's ``attention_ref``; its precision against an fp64
backward at the training shape, with one TF32 product beside it; and the
launch rule ``kernel.bwd_plan`` that picks the instance.  The kernel itself
is held against both plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py's ``[k4-bwd-check]``).

Tolerance: chip_smoke.py's float32 ``FA_BWD_TOL``, each gradient within
atol max|ref| + rtol |ref| (rtol 2e-5, atol 1.6e-4: the forward's); the
model's arithmetic and the plain version's differ by TF32 splitting and the
order of fp32 sums.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as attention_ref_jax
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import (attention_bwd_3xtf32, attention_bwd_ref,
                                                     attention_fwd_ref)

RTOL, ATOL = 2e-5, 1.6e-4
# (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset, kv_len): GQA
# groups 1, 3 and 4 with ragged rows (not a multiple of the 128-row or
# 32-position tiles), a window, softcaps, a buffer read to kv_len (NaN
# beyond, inside a 32-key tile) with an offset, first rows with no key (a
# negative offset), and no valid key at all.
CASES = [
    (1, 2, 2, 64, 64, 64, True, None, None, 0, None),
    (2, 6, 2, 100, 100, 128, True, None, None, 0, None),
    (1, 8, 2, 37, 53, 128, False, None, None, 0, None),
    (1, 4, 2, 96, 96, 64, True, 16, None, 0, None),
    (1, 4, 1, 80, 80, 64, True, None, 30.0, 0, None),
    (2, 4, 2, 45, 45, 24, True, 8, 50.0, 0, None),
    (2, 6, 2, 23, 64, 24, True, None, None, 10, 33),
    (2, 6, 2, 70, 160, 128, True, None, None, 40, 101),
    (1, 4, 2, 16, 32, 64, True, None, None, -3, None),
    (1, 4, 2, 5, 40, 8, True, None, None, 3, 0),
]
IDS = [f"B{c[0]}H{c[1]}-{c[2]}T{c[3]}-{c[4]}D{c[5]}" + ("c" if c[6] else "n")
       + f"w{c[7]}s{c[8]}o{c[9]}v{c[10]}" for c in CASES]


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (ATOL max|want| + RTOL |want|): within the
    tolerance at most 1 (0 where both are exactly equal)."""
    if want.numel() == 0:
        return 0.0
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    limit = ATOL * want.abs().max() + RTOL * want.abs()
    return float(torch.where(diff > 0, diff / limit, 0.0).max())


def _inputs(case, seed=0):
    B, Hq, Hkv, Tq, Tk, D = case[:6]
    rng = np.random.default_rng(seed + 131 * Tq + Tk + D)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D), (B, Hq, Tq, D))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_model_matches_plain_backward_and_jax_vjp(case):
    """The model equals ``attention_bwd_ref`` and ``jax.vjp`` of the
    reference's ``attention_ref`` over the valid prefix within FA_BWD_TOL,
    with NaN in every key slot beyond kv_len, whose gradients are exact
    zeros."""
    B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset, kv_len = case
    q, k, v, do = _inputs(case)
    valid = Tk if kv_len is None else kv_len
    k[:, :, valid:], v[:, :, valid:] = np.nan, np.nan
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    qt, kt, vt, dot = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = attention_fwd_ref(qt, kt[:, :, :valid], vt[:, :, :valid], **kw)
    model = attention_bwd_3xtf32(qt, kt, vt, o, dot, lse, kv_len=kv_len, **kw)
    plain = attention_bwd_ref(qt, kt[:, :, :valid], vt[:, :, :valid], o, dot, lse, **kw)

    # The reference reads the whole buffer with its kv_len mask (zeros, not
    # NaN, beyond: its masked product would carry a NaN).
    kv_j = None if kv_len is None else jnp.full((B,), kv_len, jnp.int32)

    @jax.jit
    def jax_grads(q, k, v, do):
        _, vjp = jax.vjp(lambda q, k, v: attention_ref_jax(q, k, v, kv_len=kv_j, **kw), q, k, v)
        return vjp(do)

    ref_j = jax_grads(q, np.nan_to_num(k, nan=0.0), np.nan_to_num(v, nan=0.0), do)
    for i, (g, p, r) in enumerate(zip(model, plain, ref_j)):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        head = g if i == 0 else g[:, :, :valid]  # dq; dk and dv over the valid keys
        assert _share(head, p) <= 1.0
        assert _share(g, torch.tensor(np.asarray(r))) <= 1.0
    for g in model[1:]:
        assert bool((g[:, :, valid:] == 0).all())
    if valid == 0:
        assert all(bool((g == 0).all()) for g in model)


def test_3xtf32_meets_fp32_tolerance_and_tf32_alone_does_not():
    """Why the instance runs 3xTF32: at one (b, KV head) of the training
    shape (3 q heads, 1024 causal tokens, D 128, inputs N(0, 1)), the model
    of its arithmetic stays well within FA_BWD_TOL of an fp64 backward
    (about 0.01 of the limit, as the plain fp32 backward), while one TF32
    product for each of the seven products misses it by more than 5x in
    every gradient (its truncation keeps 10 mantissa bits)."""
    rng = np.random.default_rng(21)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 3, 1024, 128), (1, 1, 1024, 128), (1, 1, 1024, 128), (1, 3, 1024, 128))]
    q64, k64, v64, do64 = (torch.tensor(a, dtype=torch.float64) for a in arrs)
    o64, lse64 = attention_fwd_ref(q64, k64, v64)
    exact = attention_bwd_ref(q64, k64, v64, o64, do64, lse64)
    q, k, v, do = (torch.tensor(a) for a in arrs)
    o, lse = attention_fwd_ref(q, k, v)
    three = [_share(g, e) for g, e in zip(attention_bwd_3xtf32(q, k, v, o, do, lse), exact)]
    one = [_share(g, e) for g, e in
           zip(attention_bwd_3xtf32(q, k, v, o, do, lse, products=1), exact)]
    plain = [_share(g, e) for g, e in zip(attention_bwd_ref(q, k, v, o, do, lse), exact)]
    assert max(three) <= 0.05, three
    assert min(one) > 5.0, one
    assert max(plain) <= 0.05, plain


def test_bwd_plan_picks_the_instance_by_type_d_and_alignment():
    """The launch rule of csrc/flash_attention_bwd.cu: float32 with 16-byte
    rows and strides (``tensor_cores``) and D <= 128 runs the 3xTF32 wgmma
    instance (128 rows and 32 keys for dQ, 64 keys and 32 positions for
    dK/dV); bfloat16 or unaligned rows, and D > 128, keep the CUDA-core
    plan they had.  The wrapper's alignment test is ``_rows_vec``."""
    tc = fa_kernel.bwd_plan(128, True)
    assert tc.wgmma and (tc.dq_rows, tc.dq_keys, tc.kv_keys, tc.kv_rows) == (128, 32, 64, 32)
    assert tc.ctas(4, 24, 8, 1024, 1024) == (24 * 8 * 4, 16 * 8 * 4)
    assert fa_kernel.bwd_plan(24, True).wgmma and fa_kernel.bwd_plan(8, True).wgmma
    assert fa_kernel.bwd_plan(128) == fa_kernel.bwd_plan(128, False)
    assert not fa_kernel.bwd_plan(128, False).wgmma       # bf16 or unaligned
    assert fa_kernel.bwd_plan(256, True) == fa_kernel.bwd_plan(256)  # D 256
    assert not fa_kernel.bwd_plan(256, True).wgmma
    wide, odd = torch.zeros((1, 2, 8, 36)), torch.zeros((1, 2, 8, 33))
    assert fa_kernel._rows_vec([wide[..., :32]], 32)[2]
    assert not fa_kernel._rows_vec([wide[..., :30]], 30)[2]   # D 30
    assert not fa_kernel._rows_vec([odd[..., :32]], 32)[2]    # rows of 33 floats
    assert not fa_kernel._rows_vec([wide[..., 1:33]], 32)[2]  # 4 bytes off 16
