"""Port parity for the synthetic data pipeline (``repro_torch.data``): its
batches are the reference's (``repro.data``) bit for bit, the reference's
own tests (``tests/test_data_pipeline.py``) hold on the port, and the
prefetcher keeps order, stops and restarts, with and without a device."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as SyntheticLMJax
from repro_torch.data import Prefetcher, SyntheticLM


@pytest.mark.parametrize("vocab,seq,batch,n_micro,seed,copy_period", [
    (100, 8, 4, 2, 7, 8), (512, 32, 8, 2, 0, 8), (1000, 64, 8, 1, 1, 4),
    (200064, 16, 6, 3, 3, 8)])
def test_batches_equal_the_reference_bit_for_bit(vocab, seq, batch, n_micro, seed, copy_period):
    ours = SyntheticLM(vocab, seq, batch, n_micro=n_micro, seed=seed, copy_period=copy_period)
    ref = SyntheticLMJax(vocab, seq, batch, n_micro=n_micro, seed=seed, copy_period=copy_period)
    np.testing.assert_array_equal(ours.probs, ref.probs)
    for step in (0, 1, 13, 40):
        a, b = ours.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_batches_deterministic_in_step():
    d1 = SyntheticLM(vocab=100, seq_len=8, global_batch=4, n_micro=2, seed=7)
    d2 = SyntheticLM(vocab=100, seq_len=8, global_batch=4, n_micro=2, seed=7)
    b1, b2 = d1.batch(13), d2.batch(13)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], d1.batch(14)["tokens"])


def test_shapes_and_label_shift():
    b = SyntheticLM(vocab=50, seq_len=8, global_batch=6, n_micro=3, seed=0).batch(0)
    assert b["tokens"].shape == b["labels"].shape == (3, 2, 8)
    np.testing.assert_array_equal(b["tokens"][..., 1:], b["labels"][..., :-1])


def test_learnable_signal_present():
    b = SyntheticLM(vocab=1000, seq_len=64, global_batch=8, seed=1, copy_period=4).batch(0)
    assert (b["tokens"] == b["labels"]).mean() > 0.15


def test_iteration_is_the_step_sequence():
    d = SyntheticLM(vocab=100, seq_len=8, global_batch=4, seed=3)
    for step, b in zip(range(3), d):
        np.testing.assert_array_equal(b["labels"], d.batch(step)["labels"])


def test_prefetcher_order_and_stop():
    d = SyntheticLM(vocab=100, seq_len=8, global_batch=4, seed=3)
    pf = Prefetcher(d, start_step=5, depth=2)
    s0, b0 = pf.next()
    s1, b1 = pf.next()
    assert (s0, s1) == (5, 6)
    np.testing.assert_array_equal(b0["tokens"], d.batch(5)["tokens"])
    np.testing.assert_array_equal(b1["labels"], d.batch(6)["labels"])
    pf.stop()
    pf._thread.join(timeout=5)
    while not pf.q.empty():
        pf.next()
    with pytest.raises(RuntimeError, match="stopped"):
        pf.next()


def test_prefetcher_moves_tensors_to_its_device():
    d = SyntheticLM(vocab=100, seq_len=8, global_batch=4, n_micro=2, seed=4)
    pf = Prefetcher(d, start_step=2, depth=3, device="cpu")
    try:
        for want in (2, 3, 4):
            step, b = pf.next()
            assert step == want
            for k, v in b.items():
                assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
                assert v.dtype == torch.int32
                np.testing.assert_array_equal(v.numpy(), d.batch(step)[k])
    finally:
        pf.stop()


def test_restart_reproduces_stream():
    """Resuming at step k yields the same batch a fresh run would see, also
    through a prefetcher started at k."""
    d = SyntheticLM(vocab=100, seq_len=8, global_batch=4, seed=9)
    fresh = d.batch(42)
    resumed = SyntheticLM(vocab=100, seq_len=8, global_batch=4, seed=9).batch(42)
    np.testing.assert_array_equal(fresh["tokens"], resumed["tokens"])
    pf = Prefetcher(SyntheticLM(vocab=100, seq_len=8, global_batch=4, seed=9), start_step=42)
    try:
        step, b = pf.next()
    finally:
        pf.stop()
    assert step == 42
    np.testing.assert_array_equal(b["tokens"], fresh["tokens"])
