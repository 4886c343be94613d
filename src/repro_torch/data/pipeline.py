"""Deterministic synthetic token pipeline with background prefetch (port of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step) — restart-safe (resuming at
step k reproduces the exact stream, so checkpoint/restart does not skew
data order) and host-shardable (each host materializes only its slice).

The stream is a Zipf-ish unigram mixture with short-range correlations, so
cross-entropy is learnable (tests assert loss decreases) without any
external data dependency.  :class:`SyntheticLM` is the reference's numpy
code, copied, so its batches equal the reference's bit for bit.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch


class SyntheticLM:
    """Micro-shaped batches: tokens/labels (n_micro, mb, T) int32."""

    def __init__(
        self,
        vocab: int,
        seq_len: int,
        global_batch: int,
        n_micro: int = 1,
        seed: int = 0,
        zipf_a: float = 1.2,
        copy_period: int = 8,
    ):
        assert global_batch % n_micro == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.n_micro = n_micro
        self.seed = seed
        self.copy_period = copy_period
        # fixed unigram distribution (deterministic in seed)
        rng = np.random.default_rng(seed)
        w = rng.zipf(zipf_a, size=vocab).astype(np.float64)
        self.probs = w / w.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        shape = (self.n_micro, self.global_batch // self.n_micro, self.seq_len + 1)
        toks = rng.choice(self.vocab, size=shape, p=self.probs).astype(np.int32)
        # short-range structure: every copy_period-th token repeats its
        # predecessor (a learnable bigram signal)
        idx = np.arange(1, shape[-1], self.copy_period)
        toks[..., idx] = toks[..., idx - 1]
        return {
            "tokens": toks[..., :-1],
            "labels": toks[..., 1:],
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch.  Without a ``device`` it hands out the
    source's numpy batches, as the reference does without shardings.  With
    one (the reference's ``shardings`` become a device), the thread turns
    each batch into tensors, pinned when the device is a card, and
    :meth:`next` moves them there with ``non_blocking=True``."""

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        self.source = source
        self.device = None if device is None else torch.device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        pin = self.device is not None and self.device.type == "cuda"
        while not self._stop.is_set():
            b = self.source.batch(step)
            if self.device is not None:
                b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
                if pin:
                    b = {k: v.pin_memory() for k, v in b.items()}
            try:
                self.q.put((step, b), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self):
        while True:
            try:
                step, b = self.q.get(timeout=1.0)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise RuntimeError("prefetcher stopped")
        if self.device is not None:
            b = {k: v.to(self.device, non_blocking=True) for k, v in b.items()}
        return step, b

    def stop(self):
        self._stop.set()
