"""Plain PyTorch versions of flash attention (port of
``repro.kernels.flash_attention.ref``): a quadratic-memory direct version
(small shapes, ground truth) and a chunked online-softmax version with
O(T * chunk) memory, both over (B, H, T, D) tensors in fp32 with causal
masking, a sliding window, tanh softcap and GQA.

These are the CPU route of :func:`..ops.flash_attention` and the oracle
``chip_smoke.py`` holds the CUDA kernel against on the card.

The backward (:func:`attention_bwd_ref`, with the forward's log-sum-exp
:func:`attention_lse_ref`) is the oracle of K4's backward kernel: the
flash-attention-2 equations, which give the gradient that ``jax.vjp`` of the
reference's ``attention_ref`` gives (the reference's Pallas kernel has no
backward of its own).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..coded_matmul.ref import tf32_truncate

NEG_INF = -1e30


def _kv_mask(mask: torch.Tensor, k_pos: torch.Tensor,
             kv_len: Optional[Union[int, torch.Tensor]], B: int) -> torch.Tensor:
    """``mask`` (Tq, Tk) broadcast to (B|1, 1, Tq, Tk), with keys at or
    beyond ``kv_len`` (an int, or a (B,) tensor) masked out."""
    mask = mask[None, None]
    if kv_len is not None:
        lens = torch.as_tensor(kv_len, device=k_pos.device).reshape(-1)
        lens = lens.expand(B) if lens.numel() == 1 else lens
        mask = mask & (k_pos[None, None] < lens[:, None, None, None])
    return mask


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[Union[int, torch.Tensor]] = None,  # valid kv prefix: int or (B,)
) -> torch.Tensor:
    """Reference attention in fp32.  ``q_offset`` is the absolute position
    of q[..., 0, :] (decode: q_offset = kv_len - Tq).  GQA: Hq % Hkv == 0,
    KV head ``h // group`` (``repeat_interleave``, as ``jnp.repeat``).
    ``window``: attend only to keys with q_pos - k_pos < window."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr)
    s = s / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    mask = _kv_mask(mask, k_pos, kv_len, B)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = torch.where(denom > 0, p / denom, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return out.to(q.dtype)


def attention_chunked(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[Union[int, torch.Tensor]] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style chunked attention in plain torch: a loop over kv chunks
    with a running (max, denom, acc) online softmax.  Same semantics as
    :func:`attention_ref`; memory O(B*H*Tq*(D + chunk))."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if Tk % chunk:
        pad = chunk - Tk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if kv_len is None:
            kv_len = Tk
        Tk = Tk + pad
    qf = q.float() / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]  # (Tq, 1)
    m = torch.full((B, Hq, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Tq, D), dtype=torch.float32, device=q.device)
    for j in range(Tk // chunk):
        kj = k[:, :, j * chunk:(j + 1) * chunk].float().repeat_interleave(group, dim=1)
        vj = v[:, :, j * chunk:(j + 1) * chunk].float().repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kj)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = j * chunk + torch.arange(chunk, device=q.device)[None, :]  # (1, chunk)
        mask = torch.ones((Tq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        mask = _kv_mask(mask, k_pos, kv_len, B)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vj)
        m = m_new
    out = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    return out.to(q.dtype)


def attention_split_partials(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D)
    *,
    chunk: int,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
) -> tuple:
    """The split-K kernel's first phase in plain torch: for each chunk s of
    ``chunk`` keys of the buffer (ceil(Tk / chunk) chunks, whatever
    ``kv_len`` is), the row max m_s, the row sum l_s and the unnormalised
    output o_s over the chunk's visible keys.  A chunk with no visible key
    for a row gives m = NEG_INF, l = 0 and o = 0 there.  Returns (m, l, o),
    shaped (S, B, Hq, Tq), (S, B, Hq, Tq) and (S, B, Hq, Tq, D), in fp32."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    valid = Tk if kv_len is None else int(kv_len)
    qf = q.float()
    q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    ms, ls, os_ = [], [], []
    for c0 in range(0, Tk, chunk):
        c1 = min(c0 + chunk, Tk)
        kj = k[:, :, c0:c1].float().repeat_interleave(group, dim=1)
        vj = v[:, :, c0:c1].float().repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kj) / torch.sqrt(
            torch.tensor(D, dtype=torch.float32))
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(c0, c1, device=q.device)[None, :]
        mask = (k_pos < valid).expand(Tq, -1)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & ((q_pos - k_pos) < window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        # masked keys weigh exactly 0, and what lies in their slots (a stale
        # NaN) is never multiplied
        os_.append(torch.einsum("bhqk,bhkd->bhqd", p, torch.where(
            mask.any(dim=0)[None, None, :, None], vj, 0.0)))
    return torch.stack(ms), torch.stack(ls), torch.stack(os_)


def combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The split-K kernel's combine: with M = max_s m_s, out = sum_s
    e^(m_s - M) o_s / sum_s e^(m_s - M) l_s, skipping empty partials (l_s =
    0), and 0 for a row that no chunk saw a key of."""
    M = m.amax(dim=0)
    c = torch.where(l > 0, torch.exp(m - M), 0.0)
    L = (c * l).sum(dim=0)
    O = (c[..., None] * torch.where(l[..., None] > 0, o, 0.0)).sum(dim=0)
    return torch.where(L[..., None] > 0, O / torch.where(L > 0, L, 1.0)[..., None], 0.0)


def attention_split(q, k, v, *, chunk: int, **kw) -> torch.Tensor:
    """Attention by split-K: :func:`attention_split_partials` over chunks of
    ``chunk`` keys, then :func:`combine_partials`.  The semantics of
    :func:`attention_ref` with an int ``kv_len``; the plain model of the
    CUDA kernel's split decode."""
    return combine_partials(*attention_split_partials(q, k, v, chunk=chunk, **kw)).to(q.dtype)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b with each operand split into TF32 big and small parts by
    truncation, small.big + big.small + big.big summed in fp32
    (``products=3``) or big.big alone (``products=1``)."""
    a_big, b_big = tf32_truncate(a), tf32_truncate(b)
    if products == 1:
        return a_big @ b_big
    a_small, b_small = tf32_truncate(a - a_big), tf32_truncate(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def attention_3xtf32(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    products: int = 3,
) -> torch.Tensor:
    """The plain model of the CUDA kernel's tensor-core instance: over tiles
    of 64 keys (its BK) of the valid prefix, S = Q K^T and each tile's P V
    with every operand split into TF32 big and small parts by truncation
    (``coded_matmul.ref.tf32_truncate``) and small.big + big.small + big.big
    summed in fp32 (``products=3``; ``products=1`` keeps big.big alone, one
    TF32 product); the online softmax in fp32, each tile's P V a fresh sum
    added to the output after the rescale.  The semantics of
    :func:`attention_ref` with an int ``kv_len``, to TF32 rounding."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    valid = Tk if kv_len is None else int(kv_len)
    kf = k[:, :, :valid].float().repeat_interleave(group, dim=1)
    vf = v[:, :, :valid].float().repeat_interleave(group, dim=1)

    def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _tf32_product(a, b, products)

    qf = q.float()
    scale = 1.0 / float(D) ** 0.5
    q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    m = torch.full((B, Hq, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Tq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Hq, Tq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, valid, 64):
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        s = product(qf, kt.transpose(-1, -2)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
        mask = torch.ones((Tq, kt.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        o = o * corr[..., None] + product(p, vt)
        m = m_new
    out = torch.where(l[..., None] > 0, o / torch.where(l > 0, l, 1.0)[..., None], 0.0)
    return out.to(q.dtype)


# --- the backward ---------------------------------------------------------------

def _acc(t: torch.Tensor) -> torch.dtype:
    """The type the plain forward and backward compute in: float64 for
    float64 inputs (``torch.autograd.gradcheck``), float32 otherwise."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scores(q, k, *, causal, window, softcap, q_offset, kv_len):
    """The scores S = softcap(q k^T / sqrt(D)) over the GQA-expanded keys,
    (B, Hq, Tq, Tk) in the accumulation type, tanh(s / softcap) (None
    without a softcap) and the mask of valid (query, key) pairs."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    acc = _acc(q)
    kr = k.to(acc).repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kr) / torch.sqrt(
        torch.tensor(D, dtype=acc))
    th = None
    if softcap is not None:
        th = torch.tanh(s / softcap)
        s = softcap * th
    q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return s, th, _kv_mask(mask, k_pos, kv_len, B)


def attention_lse_ref(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D), unused: the forward's signature
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """The per-row log-sum-exp of the masked scores that the forward leaves
    for the backward, (B, Hq, Tq) in float32 (float64 for float64 inputs);
    -inf for a row with no valid key."""
    s, _, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                         q_offset=q_offset, kv_len=kv_len)
    return torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)


def _probs(s, mask, lse):
    """P = exp(S - lse) on the valid pairs, 0 elsewhere; a row with no valid
    key (lse = -inf) is all 0, never NaN."""
    lse = torch.where(torch.isfinite(lse), lse, 0.0)
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def attention_fwd_ref(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[Union[int, torch.Tensor]] = None,
) -> tuple:
    """Attention and its log-sum-exp, ``(out, lse)``: out = exp(S - lse) V,
    in q's type, computed in float32 (float64 for float64 inputs).  The
    semantics of :func:`attention_ref`; the plain forward the autograd
    function is checked with."""
    s, _, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                         q_offset=q_offset, kv_len=kv_len)
    lse = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    vr = v.to(s.dtype).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", _probs(s, mask, lse), vr)
    return out.to(q.dtype), lse


def attention_bwd_ref(
    q: torch.Tensor,    # (B, Hq, Tq, D)
    k: torch.Tensor,    # (B, Hkv, Tk, D)
    v: torch.Tensor,    # (B, Hkv, Tk, D)
    o: torch.Tensor,    # (B, Hq, Tq, D): the forward's output
    do: torch.Tensor,   # (B, Hq, Tq, D): the output's gradient
    lse: torch.Tensor,  # (B, Hq, Tq): the forward's log-sum-exp
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[Union[int, torch.Tensor]] = None,
) -> tuple:
    """The gradients ``(dq, dk, dv)`` of attention, in the inputs' types,
    computed in float32 (float64 for float64 inputs) by the
    flash-attention-2 equations: P = exp(S - lse) on the valid pairs, dV =
    P^T dO, dP = dO V^T, D_i = sum_d dO_id O_id, dS = P (dP - D), through
    the softcap dS (1 - tanh^2(s / softcap)), dQ = dS K / sqrt(D) and dK =
    dS^T Q / sqrt(D).  GQA: dK and dV sum over each KV head's group of query
    heads.  A row with no valid key gives zero gradients."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    s, th, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                          q_offset=q_offset, kv_len=kv_len)
    acc = s.dtype
    p = _probs(s, mask, lse.to(acc))
    do_, o_ = do.to(acc), o.to(acc)
    vr = v.to(acc).repeat_interleave(group, dim=1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do_)
    dp = torch.einsum("bhqd,bhkd->bhqk", do_, vr)
    delta = (do_ * o_).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if th is not None:
        ds = ds * (1 - th * th)
    scale = 1 / torch.sqrt(torch.tensor(D, dtype=acc))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(acc).repeat_interleave(group, dim=1)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc)) * scale

    def fold(g):  # (B, Hq, Tk, D) -> (B, Hkv, Tk, D): sum over each group
        return g.reshape(B, Hkv, group, Tk, D).sum(dim=2)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def attention_bwd_3xtf32(
    q: torch.Tensor,    # (B, Hq, Tq, D)
    k: torch.Tensor,    # (B, Hkv, Tk, D)
    v: torch.Tensor,    # (B, Hkv, Tk, D)
    o: torch.Tensor,    # (B, Hq, Tq, D): the forward's output
    do: torch.Tensor,   # (B, Hq, Tq, D): the output's gradient
    lse: torch.Tensor,  # (B, Hq, Tq): the forward's log-sum-exp
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    products: int = 3,
) -> tuple:
    """The plain model of the backward kernel's tensor-core instance
    (``kernel.bwd_plan(D, True)``), with its tiles.  Launch 1: per CTA of
    128 packed (t, g) rows, over tiles of 32 keys from the CTA's first
    visible key, S = Q K^T and dP = dO V^T, dS by the mask, and each
    tile's dS K a fresh sum added to dQ in fp32.  Launch 2: per block of 64
    keys, per head of the group, over tiles of 32 query positions from the
    block's first visible one, S^T, dP^T, P, w = P dtanh, dS^T = w (dP^T -
    D), and each tile's P^T dO and dS^T Q fresh sums added to dV and dK.
    Every product splits its operands into TF32 big and small parts by
    truncation and sums small.big + big.small + big.big in fp32
    (``products=3``; ``products=1``: big.big alone, one TF32 product).  The
    semantics of :func:`attention_bwd_ref` with an int ``kv_len``, to TF32
    rounding; ``(dq, dk, dv)`` in the inputs' type, keys at or beyond
    ``kv_len`` zero."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group, dev = Hq // Hkv, q.device
    valid = Tk if kv_len is None else int(kv_len)
    n_rows = group * Tq
    scale = 1.0 / float(D) ** 0.5

    def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _tf32_product(a, b, products)

    def pair_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        mask = k_pos < valid
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (q_pos - k_pos < window)
        return mask

    def capped(s: torch.Tensor) -> tuple:  # softcap(s * scale) and its derivative
        x = s * scale
        if softcap is None:
            return x, torch.ones_like(x)
        th = torch.tanh(x / softcap)
        return softcap * th, 1 - th * th

    # Per KV head: (B, Hkv, group, Tq, ...); packed rows (t, g), g fastest.
    qg, dog, og = (x.float().reshape(B, Hkv, group, Tq, D) for x in (q, do, o))
    lseg = lse.float().reshape(B, Hkv, group, Tq)
    lseg = torch.where(torch.isfinite(lseg), lseg, 0.0)  # such rows have no valid pair
    deltag = (dog * og).sum(dim=-1)
    kf, vf = k[:, :, :valid].float(), v[:, :, :valid].float()

    def packed(x: torch.Tensor) -> torch.Tensor:
        return x.transpose(2, 3).reshape(B, Hkv, n_rows, *x.shape[4:])

    qp, dop, lsep, deltap = packed(qg), packed(dog), packed(lseg), packed(deltag)
    pos = q_offset + torch.arange(n_rows, device=dev) // group

    # The CTAs of a launch are independent: each loop below runs every CTA's
    # j-th tile at once (a CTA past its last tile adds exact zeros), so each
    # CTA sums its tiles in its own order, as the kernel does.
    def tiles(lo: torch.Tensor, hi: torch.Tensor, j: int, width: int, limit: int) -> tuple:
        """Each CTA's j-th tile of ``width`` indices from ``lo``: the indices
        clamped into [0, limit) and whether each lies below the CTA's ``hi``."""
        idx = lo[:, None] + j * width + torch.arange(width, device=dev)[None, :]
        return idx.clamp(0, max(limit - 1, 0)), idx < hi[:, None]

    # Launch 1: dQ over query tiles of 128 packed rows, each over tiles of
    # 32 keys from its first visible key.
    n_cta = -(-n_rows // 128)
    first = pos[torch.arange(n_cta, device=dev) * 128]
    last = pos[torch.clamp(torch.arange(1, n_cta + 1, device=dev) * 128, max=n_rows) - 1]
    k_lo = (first - window + 1).clamp_min(0) if window is not None else torch.zeros_like(first)
    k_hi = (last + 1).clamp_max(valid) if causal else torch.full_like(first, valid)
    pad = n_cta * 128 - n_rows

    def by_cta(x: torch.Tensor) -> torch.Tensor:  # (B, Hkv, n_rows, ...) -> CTA tiles
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 3) + (0, pad))
        return x.reshape(B, Hkv, n_cta, 128, *x.shape[3:])

    qc, doc_, lsec, deltac = by_cta(qp), by_cta(dop), by_cta(lsep), by_cta(deltap)
    q_pos = by_cta(pos.expand(B, Hkv, n_rows))[0, 0][..., None]          # (n_cta, 128, 1)
    dqc = torch.zeros((B, Hkv, n_cta, 128, D), dtype=torch.float32, device=dev)
    n_j = int(((k_hi - k_lo).clamp_min(0) + 31).div(32, rounding_mode="floor").max()) if valid else 0
    for j in range(n_j):
        kidx, live = tiles(k_lo, k_hi, j, 32, valid)
        kt, vt = kf[:, :, kidx], vf[:, :, kidx]                          # (B, Hkv, n_cta, 32, D)
        mask = pair_mask(q_pos, kidx[:, None, :]) & live[:, None, :]
        x, dtanh = capped(product(qc, kt.transpose(-1, -2)))
        dp = product(doc_, vt.transpose(-1, -2))
        p = torch.where(mask, torch.exp(x - lsec[..., None]), 0.0)
        ds = torch.where(mask, p * (dp - deltac[..., None]) * dtanh, 0.0)
        dqc += product(ds, kt)
    dqp = dqc.reshape(B, Hkv, n_cta * 128, D)[:, :, :n_rows]
    dq = (dqp * scale).reshape(B, Hkv, Tq, group, D).transpose(2, 3).reshape(B, Hq, Tq, D)

    # Launch 2: dK and dV over blocks of 64 keys, per head of the group, over
    # tiles of 32 query positions from the block's first visible one.
    n_blk = -(-valid // 64)
    k0 = torch.arange(n_blk, device=dev) * 64
    nk = (valid - k0).clamp_max(64)
    t_lo = (k0 - q_offset).clamp_min(0) if causal else torch.zeros_like(k0)
    t_hi = ((k0 + nk - 1 + window - q_offset).clamp_max(Tq) if window is not None
            else torch.full_like(k0, Tq))
    kb = torch.nn.functional.pad(kf, (0, 0, 0, n_blk * 64 - valid)).reshape(B, Hkv, n_blk, 64, D)
    vb = torch.nn.functional.pad(vf, (0, 0, 0, n_blk * 64 - valid)).reshape(B, Hkv, n_blk, 64, D)
    k_pos = (k0[:, None] + torch.arange(64, device=dev)[None, :])[..., None]  # (n_blk, 64, 1)
    dkb = torch.zeros((B, Hkv, n_blk, 64, D), dtype=torch.float32, device=dev)
    dvb = torch.zeros_like(dkb)
    n_j = int(((t_hi - t_lo).clamp_min(0) + 31).div(32, rounding_mode="floor").max()) if valid else 0
    for g in range(group):
        for j in range(n_j):
            tidx, live = tiles(t_lo, t_hi, j, 32, Tq)
            qt, dot = qg[:, :, g][:, :, tidx], dog[:, :, g][:, :, tidx]  # (B, Hkv, n_blk, 32, D)
            mask = pair_mask(q_offset + tidx[:, None, :], k_pos) & live[:, None, :]
            x, dtanh = capped(product(kb, qt.transpose(-1, -2)))
            dpt = product(vb, dot.transpose(-1, -2))
            p = torch.where(mask, torch.exp(x - lseg[:, :, g][:, :, tidx][..., None, :]), 0.0)
            ds = torch.where(mask, p * dtanh * (dpt - deltag[:, :, g][:, :, tidx][..., None, :]),
                             0.0)
            dvb += product(p, dot)
            dkb += product(ds, qt)
    dk = torch.zeros((B, Hkv, Tk, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    dk[:, :, :valid] = dkb.reshape(B, Hkv, n_blk * 64, D)[:, :, :valid]
    dv[:, :, :valid] = dvb.reshape(B, Hkv, n_blk * 64, D)[:, :, :valid]
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)
