"""Port parity for the decoder in the loop (``repro_torch.core.decode``):
the pool code, the batched incremental peeling decoder, the time-exact
decode completion and the symbol-id assignments against the JAX reference
(``repro.core.decode``) on the same numpy inputs, and the reference suite's
own contracts (tests/test_decode.py) run through the port.

The decoder is integer and boolean arithmetic, so every comparison is exact
(bitwise), except completion times, which are float32 values picked out of
the same table and compared at rtol 1e-6.
"""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import decode as dec_jax
from repro.core import engine as eng_jax
from repro.core import fountain as f_jax
from repro_torch.core import decode as dec_pt
from repro_torch.core import engine as eng_pt
from repro_torch.core import fountain as f_pt
from repro_torch.core.decode import peeling as peeling_pt

STATE_KEYS = ("recovered", "rx", "res_deg", "count", "ripple", "done")


def _closure_ref(code, keep):
    """Pure-python peeling closure (the fixpoint both decoders must hit)."""
    known: set = set()
    nbrs = [set(code.idx[b, code.mask[b]].tolist()) for b in keep]
    changed = True
    while changed:
        changed = False
        for s in nbrs:
            rem = s - known
            if len(rem) == 1:
                known.add(rem.pop())
                changed = True
    return known


def _same_state(state_pt, states_jax):
    """The port's batched state equals the reference's per-rep states."""
    for r, sj in enumerate(states_jax):
        for k in STATE_KEYS:
            assert np.array_equal(state_pt[k][r].numpy(), np.asarray(sj[k])), (r, k)


@pytest.mark.parametrize("R,K,kw", [
    (16, None, {}), (40, 40, dict(seed=3, d_max=8)), (200, None, {}),
    (64, 64, dict(seed=7)),
])
def test_make_decoder_code_equals_reference(R, K, kw):
    cj, cp = dec_jax.make_decoder_code(R, K, **kw), dec_pt.make_decoder_code(R, K, **kw)
    assert (cj.R, cj.K) == (cp.R, cp.K)
    for field in ("idx", "mask", "coef"):
        x, y = getattr(cj, field), getattr(cp, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert dec_pt.DEC_DMAX == dec_jax.DEC_DMAX and dec_pt.DEC_SEED == dec_jax.DEC_SEED
    tj, tp = dec_jax.make_tables(cj), dec_pt.make_tables(cp, "cpu")
    assert np.array_equal(tp["idx"].numpy(), np.asarray(tj["idx"]))
    assert np.array_equal(tp["mask"].numpy(), np.asarray(tj["mask"]))
    aux = dec_pt.decoder_aux(R, 2, "cpu", K_pool=K, **kw)
    _same_state(aux["state0"], [dec_jax.init_state(R, tj)] * 2)
    assert np.array_equal(dec_pt.slot_ids(5, 7, "cpu").numpy(),
                          np.asarray(dec_jax.slot_ids(5, 7)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_absorb_and_peel_equal_reference_on_batches(seed):
    """Three reps absorb different arrival streams in chunks of 5, with
    unreceived lanes, duplicate ids and ids past the pool (wrapping); the
    port's batched state equals each rep's reference state after every
    absorb."""
    R, K = 24, 32
    code = dec_pt.make_decoder_code(R, K, seed=seed, d_max=8)
    tj = dec_jax.make_tables(dec_jax.make_decoder_code(R, K, seed=seed, d_max=8))
    tp = dec_pt.make_tables(code, "cpu")
    rng = np.random.default_rng(seed)
    B, steps, n = 3, 14, 5
    ids = rng.integers(0, R + 2 * K, size=(B, steps, n)).astype(np.int32)
    ids[:, 3] = ids[:, 2]  # a whole batch of duplicates
    received = rng.random((B, steps, n)) < 0.8
    sp = dec_pt.init_state(R, tp, B)
    sj = [dec_jax.init_state(R, tj) for _ in range(B)]
    for i in range(steps):
        sp = dec_pt.absorb(sp, tp, torch.as_tensor(ids[:, i]), torch.as_tensor(received[:, i]))
        sj = [dec_jax.absorb(s, tj, jnp.asarray(ids[r, i]), jnp.asarray(received[r, i]))
              for r, s in enumerate(sj)]
        _same_state(sp, sj)
    assert bool(sp["done"].any())  # the streams run far enough to decode


def test_peel_round_equals_reference():
    R, K = 20, 24
    code = dec_pt.make_decoder_code(R, K, seed=5, d_max=8)
    tj = dec_jax.make_tables(dec_jax.make_decoder_code(R, K, seed=5, d_max=8))
    tp = dec_pt.make_tables(code, "cpu")
    rng = np.random.default_rng(4)
    rec = rng.random((2, R)) < 0.6
    rx = rng.random((2, K)) < 0.7
    deg = code.mask[R:].sum(1)
    res = np.stack([deg - (code.mask[R:] & r[code.idx[R:]]).sum(1) for r in rec]).astype(np.int32)
    out_p = dec_pt.peel_round(torch.as_tensor(rec), torch.as_tensor(res),
                              torch.as_tensor(rx), tp)
    for r in range(2):
        out_j = dec_jax.peel_round(jnp.asarray(rec[r]), jnp.asarray(res[r]),
                                   jnp.asarray(rx[r]), tj)
        for a, b in zip(out_p, out_j):
            assert np.array_equal(a[r].numpy(), np.asarray(b))


@settings(max_examples=20, deadline=None)
@given(
    R=st.integers(min_value=8, max_value=40),
    k_frac=st.floats(min_value=0.5, max_value=1.5),
    seed=st.integers(min_value=0, max_value=500),
    data=st.data(),
)
def test_property_incremental_matches_offline_closure(R, k_frac, seed, data):
    """Any loss pattern, absorbed in any order and any batch size, lands on
    exactly the offline peeling closure: done iff peel_decode_plan
    succeeds, recovered mask == the closure set even on a stall.  Two reps
    take two arrival orders of the same set in one batch."""
    K = max(4, int(R * k_frac))
    code = dec_pt.make_decoder_code(R, K, seed=seed, d_max=8)
    tables = dec_pt.make_tables(code, "cpu")
    n_lost = data.draw(st.integers(min_value=0, max_value=max(1, (R + K) // 3)))
    rng = np.random.default_rng(seed + 1)
    lost = rng.choice(R + K, size=n_lost, replace=False)
    keep = np.setdiff1d(np.arange(R + K), lost)
    orders = np.stack([rng.permutation(keep), rng.permutation(keep)])
    state = dec_pt.init_state(R, tables, 2)
    chunk = data.draw(st.integers(min_value=1, max_value=5))
    for c0 in range(0, orders.shape[1], chunk):
        ids = torch.as_tensor(orders[:, c0:c0 + chunk])
        state = dec_pt.absorb(state, tables, ids, torch.ones(ids.shape, dtype=torch.bool))
    plan = f_pt.peel_decode_plan(code, keep)
    closure = _closure_ref(code, keep)
    for r in range(2):
        assert bool(state["done"][r]) == (plan is not None)
        assert set(np.flatnonzero(state["recovered"][r].numpy())) == closure
        assert int(state["count"][r]) == len(closure)


def test_absorb_ignores_unreceived_and_duplicates():
    R, K = 12, 16
    code = dec_pt.make_decoder_code(R, K, seed=3, d_max=8)
    tables = dec_pt.make_tables(code, "cpu")
    state = dec_pt.init_state(R, tables, 1)
    ids = torch.arange(8)
    state = dec_pt.absorb(state, tables, ids, torch.zeros(8, dtype=torch.bool))
    assert int(state["count"][0]) == 0 and not bool(state["rx"].any())
    state = dec_pt.absorb(state, tables, ids, torch.ones(8, dtype=torch.bool))
    twice = dec_pt.absorb(state, tables, ids, torch.ones(8, dtype=torch.bool))
    assert torch.equal(state["recovered"], twice["recovered"])
    assert torch.equal(state["res_deg"], twice["res_deg"])
    assert int(twice["ripple"][0]) == 0


def test_decode_failure_insufficient_overhead():
    """Losing a source covered by no received parity must stall, not lie."""
    code = f_pt.make_lt_code(R=8, K=0, seed=0)
    tables = {"idx": torch.zeros((1, 1), dtype=torch.int64),
              "mask": torch.zeros((1, 1), dtype=torch.bool)}
    state = dec_pt.init_state(8, tables, 1)
    keep = np.setdiff1d(np.arange(8), [3])
    state = dec_pt.absorb(state, tables, torch.as_tensor(keep),
                          torch.ones(keep.size, dtype=torch.bool))
    assert not bool(state["done"][0]) and int(state["count"][0]) == 7
    assert f_pt.peel_decode_plan(code, keep) is None


@pytest.mark.parametrize("loss,seed", [(0.15, 0), (0.3, 1), (0.9, 2)])
@pytest.mark.parametrize("assign", ["round_robin", "send_order", "tx_end"])
def test_decode_completion_equals_reference(loss, seed, assign):
    """(T, valid, k_star) of each rep equal the reference's on the same
    arrival table and ids: the round-robin grid, the send-order ids of a
    tied send trace, and the tx_end certification."""
    R, N, M, B = 16, 4, 20, 3
    tj = dec_jax.make_tables(dec_jax.make_decoder_code(R))
    tp = dec_pt.make_tables(dec_pt.make_decoder_code(R), "cpu")
    rng = np.random.default_rng(seed)
    tr = rng.uniform(1.0, 100.0, (B, N, M)).astype(np.float32)
    tr[rng.random((B, N, M)) < loss] = np.inf
    tr[:, :, 5] = tr[:, :1, 5]  # tied arrivals: the time sort must be stable
    tx = np.floor(rng.uniform(0.0, 8.0, (B, N, M))).astype(np.float32)  # many ties
    tx_end = rng.uniform(50.0, 120.0, (B, N)).astype(np.float32)
    ids_p = dec_pt.send_order_ids(torch.as_tensor(tx)) if assign != "round_robin" else None
    out_p = dec_pt.decode_completion(
        torch.as_tensor(tr), tp, R, ids=ids_p,
        tx_end=torch.as_tensor(tx_end) if assign == "tx_end" else None)
    for r in range(B):
        ids_j = dec_jax.send_order_ids(jnp.asarray(tx[r])) if ids_p is not None else None
        if ids_j is not None:
            assert np.array_equal(ids_p[r].numpy(), np.asarray(ids_j))
        out_j = dec_jax.decode_completion(
            jnp.asarray(tr[r]), tj, R, ids=ids_j,
            tx_end=jnp.asarray(tx_end[r]) if assign == "tx_end" else None)
        np.testing.assert_allclose(out_p[0][r].numpy(), np.asarray(out_j[0]), rtol=1e-6)
        assert bool(out_p[1][r]) == bool(out_j[1])
        assert int(out_p[2][r]) == int(out_j[2])


@pytest.mark.parametrize("loss,seed", [(0.15, 0), (0.3, 1), (0.9, 2)])
def test_decode_completion_matches_bruteforce_replay(loss, seed):
    R, N, M = 16, 4, 20
    tables = dec_pt.make_tables(dec_pt.make_decoder_code(R), "cpu")
    rng = np.random.default_rng(seed)
    tr = rng.uniform(1.0, 100.0, (N, M))
    tr[rng.random((N, M)) < loss] = np.inf
    t, valid, k_star = dec_pt.decode_completion(
        torch.as_tensor(tr, dtype=torch.float32)[None], tables, R)
    ids = (np.arange(M)[None, :] * N + np.arange(N)[:, None]).reshape(-1)
    flat = tr.reshape(-1).astype(np.float32)
    order = np.argsort(flat, kind="stable")
    state = dec_pt.init_state(R, tables, 1)
    bf_k, bf_t = None, np.inf
    for j, o in enumerate(order):
        if not np.isfinite(flat[o]):
            break
        state = dec_pt.absorb(state, tables, torch.as_tensor([ids[o]]),
                              torch.as_tensor([True]))
        if bool(state["done"][0]):
            bf_k, bf_t = j + 1, flat[o]
            break
    if bf_k is None:
        assert not bool(valid[0]) and not np.isfinite(float(t[0]))
    else:
        assert int(k_star[0]) == bf_k
        np.testing.assert_allclose(float(t[0]), bf_t, rtol=1e-6)


def test_send_time_ids_equal_reference_on_ties():
    """Simultaneous sends keep the round-robin order (a stable sort by helper
    index); earlier senders draw earlier symbols; unsent slots consume
    nothing.  Every case equals the reference's ``_send_time_ids``."""
    cases = [
        (0, [0.0] * 5, [True] * 5),
        (10, [3.0, 1.0, np.inf, 2.0], [True, True, False, True]),
        (2, [5.0, np.inf, 6.0], [True, False, True]),
        (7, [1.0, 1.0, 0.5, 1.0, np.inf, 0.5], [True] * 4 + [False, True]),
    ]
    for nxt, tx, sent in cases:
        tx, sent = np.float32(tx), np.asarray(sent)
        ids_p, nxt_p = eng_pt._send_time_ids(
            torch.tensor([nxt, nxt + 3], dtype=torch.int32),
            torch.as_tensor(tx).expand(2, -1), torch.as_tensor(sent).expand(2, -1))
        ids_j, nxt_j = eng_jax._send_time_ids(jnp.int32(nxt), jnp.asarray(tx),
                                              jnp.asarray(sent))
        assert np.array_equal(ids_p[0].numpy(), np.asarray(ids_j))
        assert np.array_equal(ids_p[1].numpy(), np.asarray(ids_j) + 3)
        assert int(nxt_p[0]) == int(nxt_j) and int(nxt_p[1]) == int(nxt_j) + 3
    ids, nxt = eng_pt._send_time_ids(torch.zeros(1, dtype=torch.int32),
                                     torch.zeros((1, 5)), torch.ones((1, 5), dtype=torch.bool))
    assert np.array_equal(ids[0].numpy(), np.arange(5)) and int(nxt[0]) == 5


def test_send_order_ids_equal_reference_on_ties():
    """Lockstep (all-equal tx per round) reproduces the round-robin grid bit
    for bit; heterogeneous tx ranks strictly by send instant; unsent slots
    rank after every real send."""
    N, M = 4, 3
    lock = np.tile(np.arange(M, dtype=np.float32)[None, :], (N, 1))
    grid = np.arange(M)[None, :] * N + np.arange(N)[:, None]
    cases = [lock, np.float32([[0.0, 1.0, 2.0], [10.0, 11.0, 12.0]]),
             np.float32([[0.0, np.inf], [1.0, 2.0]]),
             np.floor(np.random.default_rng(0).uniform(0, 3, (6, 5))).astype(np.float32)]
    for tx in cases:
        ids_p = dec_pt.send_order_ids(torch.as_tensor(tx)[None])[0].numpy()
        assert np.array_equal(ids_p, np.asarray(dec_jax.send_order_ids(jnp.asarray(tx))))
    assert np.array_equal(dec_pt.send_order_ids(torch.as_tensor(lock)[None])[0].numpy(), grid)
    ids = dec_pt.send_order_ids(torch.as_tensor(cases[2])[None])[0].numpy()
    assert ids[0, 1] == 3 and sorted(ids.ravel()) == [0, 1, 2, 3]


def test_plan_rounds_levelization_is_consistent_on_the_decoder_code():
    """The port's peeling plan and its rounds equal the reference's on the
    decoder's pool code, every peeled source appears in exactly one round,
    and a round depends only on direct sources or earlier rounds."""
    code_p = dec_pt.make_decoder_code(24, 30, seed=9, d_max=8)
    code_j = dec_jax.make_decoder_code(24, 30, seed=9, d_max=8)
    for lost in ([1, 5, 8, 13, 21], [0, 2, 3, 30, 40], []):
        keep = np.setdiff1d(np.arange(54), lost)
        plan, plan_j = f_pt.peel_decode_plan(code_p, keep), f_jax.peel_decode_plan(code_j, keep)
        assert plan is not None and plan_j is not None
        for field in ("direct_src", "direct_coded", "direct_coef", "order_coded",
                      "order_src", "order_pivot", "order_nbr_idx", "order_nbr_coef"):
            assert np.array_equal(getattr(plan, field), getattr(plan_j, field)), field
        rounds, rounds_j = f_pt.plan_rounds(plan), f_jax.plan_rounds(plan_j)
        assert len(rounds) == len(rounds_j)
        for rnd, rnd_j in zip(rounds, rounds_j):
            for field in ("coded", "src", "pivot", "nbr_idx", "nbr_coef"):
                assert np.array_equal(getattr(rnd, field), getattr(rnd_j, field)), field
        seen = set(plan.direct_src.tolist())
        all_round_src = []
        for rnd in rounds:
            for t in range(rnd.size):
                nbrs = rnd.nbr_idx[t][rnd.nbr_coef[t] != 0]
                assert set(nbrs.tolist()) <= seen, "forward dependency"
            seen |= set(rnd.src.tolist())
            all_round_src.extend(rnd.src.tolist())
        assert sorted(all_round_src) == sorted(plan.order_src.tolist())


def test_offline_overhead_samples_equal_reference():
    R = 40
    got = dec_pt.offline_overhead_samples(R, dec_pt.make_decoder_code(R), 0.1, trials=6, seed=3)
    want = dec_jax.offline_overhead_samples(R, dec_jax.make_decoder_code(R), 0.1, trials=6, seed=3)
    assert np.array_equal(got, want) and (got >= 0).any()


def test_decoder_loops_count_their_host_syncs():
    R = 16
    tables = dec_pt.make_tables(dec_pt.make_decoder_code(R), "cpu")
    before = peeling_pt.host_syncs
    state = dec_pt.absorb(dec_pt.init_state(R, tables, 2), tables,
                          torch.arange(R + 8), torch.ones(R + 8, dtype=torch.bool))
    assert bool(state["done"].all())
    assert peeling_pt.host_syncs >= before + 1
