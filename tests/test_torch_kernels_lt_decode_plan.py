"""K3's own interface on the CPU: the program that one launch walks
(``repro_torch.kernels.lt_decode.schedule``) and its plain version
(``ref.lt_decode_program_ref``), on the same numpy inputs as the JAX
reference.  A plan's rounds (``plan_program``) against the port's
round-based plain decode (``lt_decode_ref``, bit for bit) and the
reference's Pallas kernel in interpret mode (1e-5, the reference suite's
kernel tolerance); its steps in plan order (``scan_program``, what
``fountain.decode`` runs on the card) against the port's and the
reference's ``fountain.apply_decode_plan`` (1e-5).  Non-finite values are
compared NaN-equal.  Also the padding lists on a hand-built plan, a program
that spans chunks, and ``fountain.decode``'s CPU route.  The CUDA kernel itself is held against these in
tests/test_torch_cuda.py (card only).
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as dec_jax
from repro.core import fountain as f_jax
from repro.kernels.lt_decode import lt_decode as dec_payload_jax
from repro_torch.core import decode as dec_pt
from repro_torch.core import fountain as f_pt
from repro_torch.kernels import lt_decode as k3
from repro_torch.kernels.lt_decode import schedule
from repro_torch.kernels.lt_encode import lt_encode_code

# tests/test_torch_kernels_lt_decode.py's SHAPES: (R, K, bm, cols, bc, lost sources).
SHAPES = [(12, 10, 4, 24, 8, 3), (20, 24, 8, 16, 16, 6), (8, 8, 16, 40, 8, 2)]


def _inputs(R, K, bm, cols, case):
    """Encode random sources with the decoder's pool code and lose sources.
    ``nonfinite``: an inf and a NaN in received source block 0, which the
    plan's padding slots name.  ``block0``: block 0 lost, with an inf in the
    coded block that recovers it, in a round with other entries that name
    block 0 in padding slots, and before a round with such entries."""
    n_lost = dict((s[0], s[5]) for s in SHAPES)[R]
    code = dec_pt.make_decoder_code(R, K, seed=R + K, d_max=8)
    x = np.random.default_rng(R).standard_normal((R * bm, cols)).astype(np.float32)
    coded = lt_encode_code(torch.as_tensor(x), code, bm=bm).numpy().reshape(R + K, bm, cols)
    # block0 loses more sources where the shape's own count gives no such round.
    tries = [(n, seed) for n in (range(n_lost, R // 2) if case == "block0" else [n_lost])
             for seed in range(100)]
    for n, seed in tries:
        lost = np.random.default_rng(n + seed).choice(R, size=n, replace=False)
        if case == "block0":
            lost[0] = 0
            lost = np.unique(lost)
        elif case == "nonfinite":
            lost = lost[lost != 0]
        keep = np.setdiff1d(np.arange(R + K), lost)
        plan = f_pt.peel_decode_plan(code, keep)
        if plan is None:
            continue
        crx = coded[keep].copy()
        if case == "nonfinite":
            crx[0, min(2, bm - 1), 1], crx[0, 0, 0] = np.inf, np.nan  # received block 0
            return code, keep, plan, crx.reshape(-1, cols), None
        if case != "block0":
            return code, keep, plan, crx.reshape(-1, cols), None
        rounds = f_pt.plan_rounds(plan)
        r0 = next(i for i, r in enumerate(rounds) if 0 in r.src)
        later = [r for r in rounds[r0 + 1:] if (r.nbr_coef == 0).any()]
        same = rounds[r0].size > 1 and (rounds[r0].nbr_coef == 0).any()
        if later and same:
            crx[rounds[r0].coded[list(rounds[r0].src).index(0)], bm - 1, cols - 1] = np.inf
            return code, keep, plan, crx.reshape(-1, cols), r0
    raise AssertionError(f"no {case} loss pattern found at R{R}K{K}")


def _program_decode(crx, plan, bm, program="rounds"):
    """What lt_decode does on the card, with the plain version in the
    kernel's place: the direct fills into a buffer whose other blocks hold
    NaN (the kernel reads only blocks it was given or wrote), then the
    plan's program (``scan``: ``lt_decode(scan=True)``'s)."""
    R, cols = plan.R, crx.shape[1]
    src = torch.full((R * bm, cols), torch.nan, dtype=crx.dtype)
    c3 = crx.view(-1, bm, cols)
    src.view(R, bm, cols)[torch.as_tensor(plan.direct_src).long()] = (
        c3[torch.as_tensor(plan.direct_coded).long()]
        / torch.as_tensor(plan.direct_coef).to(crx.dtype)[:, None, None])
    build = schedule.scan_program if program == "scan" else schedule.plan_program
    return k3.lt_decode_program_ref(crx, src, build(plan, crx.shape[0] // bm), bm=bm)


def _scan_decode_equals_apply_decode_plan(crx, plan, keep, R, K, bm, cols, case):
    """The scan program's plain version against the port's and the JAX
    reference's apply_decode_plan; with block 0 recovered inf at step t0,
    the steps before t0 stay finite and those after it whose padding slots
    name block 0 turn NaN."""
    crx_t = torch.as_tensor(crx)
    out = _program_decode(crx_t, plan, bm, "scan")
    ref = f_pt.apply_decode_plan(crx_t.view(-1, bm, cols), plan).view(R * bm, cols)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5, equal_nan=True)
    torch.testing.assert_close(k3.lt_decode(crx_t, plan, bm=bm, scan=True), ref, rtol=0, atol=0,
                               equal_nan=True)  # a CPU tensor's scan is apply_decode_plan
    plan_j = f_jax.peel_decode_plan(dec_jax.make_decoder_code(R, K, seed=R + K, d_max=8), keep)
    jax_out = f_jax.apply_decode_plan(jnp.asarray(crx).reshape(-1, bm, cols), plan_j)
    torch.testing.assert_close(out, torch.as_tensor(np.array(jax_out)).view(R * bm, cols),
                               rtol=1e-5, atol=1e-5, equal_nan=True)
    assert (case == "loss") == bool(torch.isfinite(ref).all())
    if case == "block0":
        t0 = list(plan.order_src).index(0)
        at = ref.view(R, bm, cols)[torch.as_tensor(plan.order_src).long(), bm - 1, cols - 1]
        assert not bool(torch.isfinite(at[t0])) and bool(torch.isfinite(at[:t0]).all())
        pads0 = ((plan.order_nbr_coef == 0) & (plan.order_nbr_idx == 0)).any(axis=1)
        assert bool(torch.isnan(at[t0 + 1:][torch.as_tensor(pads0[t0 + 1:])]).all())


@pytest.mark.parametrize("program", ["rounds", "scan"])
@pytest.mark.parametrize("case", ["loss", "nonfinite", "block0"])
@pytest.mark.parametrize("R,K,bm,cols,bc,n_lost", SHAPES)
def test_program_plain_version_equals_plain_decode_and_reference(R, K, bm, cols, bc, n_lost,
                                                                 case, program):
    code, keep, plan, crx, r0 = _inputs(R, K, bm, cols, case)
    if program == "scan":
        _scan_decode_equals_apply_decode_plan(crx, plan, keep, R, K, bm, cols, case)
        return
    crx_t = torch.as_tensor(crx)
    out = _program_decode(crx_t, plan, bm)
    ref = k3.lt_decode_ref(crx_t, plan, bm=bm)
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    plan_j = f_jax.peel_decode_plan(dec_jax.make_decoder_code(R, K, seed=R + K, d_max=8), keep)
    pallas = dec_payload_jax(jnp.asarray(crx), plan_j, bm=bm, use_pallas=True,
                             interpret=True, bc=bc)
    torch.testing.assert_close(out, torch.as_tensor(np.array(pallas)), rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    assert (case == "loss") == bool(torch.isfinite(ref).all())
    if case == "block0":
        # Block 0 is recovered non-finite in round r0: the entries of round
        # r0 still read zeros through their padding slots, later ones NaN.
        rounds = f_pt.plan_rounds(plan)
        at = ref.view(R, bm, cols)[:, bm - 1, cols - 1]
        assert not bool(torch.isfinite(at[0]))
        assert all(bool(torch.isfinite(at[int(s)])) for s in rounds[r0].src if s != 0)
        assert any(bool(torch.isnan(at[int(s)]))
                   for r in rounds[r0 + 1:] for s in r.src[(r.nbr_coef == 0).any(axis=1)])


def test_program_plain_version_bf16_matches_reference():
    R, K, bm, cols, bc, _ = SHAPES[1]
    _code, keep, plan, crx, _ = _inputs(R, K, bm, cols, "loss")
    crx_t = torch.as_tensor(crx).to(torch.bfloat16)
    out = _program_decode(crx_t, plan, bm)
    torch.testing.assert_close(out, k3.lt_decode_ref(crx_t, plan, bm=bm), rtol=0, atol=0)
    plan_j = f_jax.peel_decode_plan(dec_jax.make_decoder_code(R, K, seed=R + K, d_max=8), keep)
    pallas = dec_payload_jax(jnp.asarray(crx_t.float().numpy()).astype(jnp.bfloat16), plan_j,
                             bm=bm, use_pallas=True, interpret=True, bc=bc)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(pallas, np.float32),
                               atol=2e-2 * 4, rtol=2e-2)


def _hand_plan():
    """R=6, blocks 0 and 5 received; width 4, padding slots name the blocks
    listed after each step's real neighbours."""
    idx = np.array([[5, 0, 0, 0],    # t0: 2 = f(5), round 1; pads 0 (direct)
                    [3, 2, 0, 0],    # t1: 1, no real neighbour, round 1; pads 3 (unknown), 2 (same round), 0
                    [2, 0, 1, 5],    # t2: 3 = f(2), round 2; pads 0, 1, 5 (all known)
                    [3, 0, 2, 4]],   # t3: 4 = f(3, 0), round 3; pads 2 (known), 4 (itself)
                   dtype=np.int32)
    coef = np.array([[1, 0, 0, 0], [0, 0, 0, 0], [-1, 0, 0, 0], [1, -1, 0, 0]],
                    dtype=np.float32)
    return f_pt.DecodePlan(
        direct_src=np.array([0, 5], np.int32), direct_coded=np.array([0, 1], np.int32),
        direct_coef=np.ones(2, np.float32), order_coded=np.array([2, 3, 4, 5], np.int32),
        order_src=np.array([2, 1, 3, 4], np.int32), order_pivot=np.array([1, -1, 1, 1],
                                                                          np.float32),
        order_nbr_idx=idx, order_nbr_coef=coef, R=6)


def test_padding_lists_and_entries_pinned_on_a_hand_built_plan():
    plan = _hand_plan()
    assert list(f_pt.plan_step_rounds(plan)) == [1, 1, 2, 3]
    rounds = schedule.read_program(schedule.plan_program(plan, n_rx=6))
    assert [r.padding.tolist() for r in rounds] == [[0], [0, 1, 5], [2]]
    assert [r.width for r in rounds] == [4, 4, 4]
    ents = [e for r in rounds for e in r.entries]
    assert [(e.cpos, e.dst, e.padmask, e.inv_pivot) for e in ents] == [
        (2, 2, 0b1, 1.0), (3, 1, 0b1, -1.0), (4, 3, 0b111, 1.0), (5, 4, 0b1, 1.0)]
    assert [e.idx.tolist() for e in ents] == [[5], [], [2], [3, 0]]
    assert [e.w.tolist() for e in ents] == [[1.0], [], [-1.0], [1.0, -1.0]]
    # One round read as src stands: every block its padding slots name.
    one = schedule.read_program(schedule.round_program(
        plan.order_coded, plan.order_src, plan.order_nbr_idx, plan.order_nbr_coef,
        1.0 / plan.order_pivot, R=6, n_rx=6))
    assert len(one) == 1 and one[0].padding.tolist() == [0, 1, 2, 3, 4, 5]
    assert [e.padmask for e in one[0].entries] == [0b1, 0b1101, 0b100011, 0b10100]
    # Entries outside the buffers are dropped; a record never straddles a chunk.
    kept = schedule.read_program(schedule.round_program(
        [2, -1, 9], [2, 1, 3], plan.order_nbr_idx[:3], plan.order_nbr_coef[:3],
        np.ones(3, np.float32), R=6, n_rx=6))
    assert [e.dst for e in kept[0].entries] == [2]
    # In plan order, one step a round: t1's padding reads block 2, which t0
    # recovered just before it; block 3 is still unknown.
    scan = schedule.read_program(schedule.scan_program(plan, n_rx=6))
    assert [r.padding.tolist() for r in scan] == [[0], [0, 2], [0, 1, 5], [2]]
    assert [[(e.dst, e.padmask) for e in r.entries] for r in scan] == [
        [(2, 0b1)], [(1, 0b11)], [(3, 0b111)], [(4, 0b1)]]


def test_program_spans_chunks_at_the_default_size():
    """Records that would straddle a CHUNK_WORDS boundary start the next
    chunk, after zero words; the program reads back entry for entry, and a
    record longer than a chunk is refused."""
    R, S, nnz = 2100, 3, 700  # entries of 5 + 2 * 700 words: the third straddles
    idx = np.arange(1, 1 + S * nnz).reshape(S, nnz) % R
    w = np.full((S, nnz), 0.5, np.float32)
    words = schedule.round_program(np.arange(S), np.arange(S), idx, w, np.ones(S, np.float32),
                                   R=R, n_rx=S)
    n = 5 + 2 * nnz
    assert words.size == schedule.CHUNK_WORDS + n + 3 and words.size % 4 == 0
    assert words[2 + 2 * n:schedule.CHUNK_WORDS].tolist() == [0] * (
        schedule.CHUNK_WORDS - 2 - 2 * n)
    assert words[schedule.CHUNK_WORDS] == (nnz << 2) | schedule.OP_ENTRY
    again = schedule.read_program(words)
    assert len(again) == 1 and [(e.cpos, e.dst, e.idx.tolist()) for e in again[0].entries] == [
        (s, s, idx[s].tolist()) for s in range(S)]
    big = schedule.CHUNK_WORDS // 2
    with pytest.raises(ValueError, match="exceeds CHUNK_WORDS"):
        schedule.round_program([0], [0], np.arange(big)[None] % R, np.ones((1, big), np.float32),
                               np.ones(1, np.float32), R=R, n_rx=1)


def test_scan_program_plain_version_on_the_hand_built_plan():
    """Block 2 recovered with an inf by t0: in plan order t1's padding slot
    reads it (NaN, as in the port's and the reference's apply_decode_plan),
    where the round program still reads it as zeros (finite)."""
    import dataclasses

    plan = _hand_plan()
    bm, cols = 2, 3
    crx = torch.as_tensor(np.random.default_rng(1).standard_normal((6 * bm, cols)),
                          dtype=torch.float32)
    crx[2 * bm, 1] = torch.inf  # t0's coded block: block 2
    out = _program_decode(crx, plan, bm, "scan")
    ref = f_pt.apply_decode_plan(crx.view(6, bm, cols), plan).view(6 * bm, cols)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6, equal_nan=True)
    plan_j = f_jax.DecodePlan(**{f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)})
    jax_out = f_jax.apply_decode_plan(jnp.asarray(crx.numpy()).reshape(6, bm, cols), plan_j)
    torch.testing.assert_close(out, torch.as_tensor(np.array(jax_out)).view(6 * bm, cols),
                               rtol=1e-6, atol=1e-6, equal_nan=True)
    assert bool(torch.isnan(out.view(6, bm, cols)[1, 0, 1]))
    assert bool(torch.isfinite(_program_decode(crx, plan, bm).view(6, bm, cols)[1, 0, 1]))


def test_program_plain_version_on_the_hand_built_plan():
    """Non-finite values in each padding block: NaN exactly where a block
    known before the entry's round is non-finite, equal to lt_decode_ref."""
    plan = _hand_plan()
    bm, cols = 2, 3
    crx = torch.as_tensor(np.random.default_rng(0).standard_normal((6 * bm, cols)),
                          dtype=torch.float32)
    crx[0, 0] = torch.inf      # block 0 (direct): every later padding slot on it
    crx[3, 1] = torch.nan      # block 5 (direct), row 1: t0's real neighbour, t2's padding
    crx[6, 2] = -torch.inf     # t1's coded block: block 1, padding of t2
    out = _program_decode(crx, plan, bm)
    ref = k3.lt_decode_ref(crx, plan, bm=bm)
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(ref.view(6, bm, cols)[3, 0, 2]))  # t2 pads block 1's -inf


def test_fountain_decode_on_cpu_takes_apply_decode_plan(monkeypatch):
    R, K, bm, cols, _bc, n_lost = SHAPES[0]
    code, keep, plan, crx, _ = _inputs(R, K, bm, cols, "loss")
    calls = []
    plain = f_pt.apply_decode_plan
    monkeypatch.setattr(f_pt, "apply_decode_plan",
                        lambda *a: calls.append(1) or plain(*a))

    def no_kernel(*a, **k):
        raise AssertionError("the CPU route reached the kernel's entry")

    monkeypatch.setattr(k3, "lt_decode", no_kernel)
    out, method = f_pt.decode(torch.as_tensor(crx).view(len(keep), bm, cols), code, keep)
    assert method == "peel" and calls == [1]
    torch.testing.assert_close(out.reshape(-1, cols), k3.lt_decode_ref(torch.as_tensor(crx), plan,
                                                                       bm=bm),
                               rtol=1e-5, atol=1e-5)


def test_plan_wrapper_refuses_cpu_tensors():
    R, K, bm, cols, _bc, _ = SHAPES[0]
    _code, keep, plan, crx, _ = _inputs(R, K, bm, cols, "loss")
    words = torch.as_tensor(schedule.plan_program(plan, len(keep)))
    before = k3.lt_decode_plan_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3.lt_decode_plan_cuda(torch.as_tensor(crx), torch.zeros((R * bm, cols)), words, bm)
    assert k3.lt_decode_plan_cuda.launches == before
