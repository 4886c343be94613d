"""Serving runtime: batched prefill/decode with CCP request dispatch (port
of ``repro.runtime.serve_loop``).

One ``ServeEngine`` wraps a model + params on one device and exposes
generate() over batched requests.  ``CCPDispatcher`` spreads request batches
over several (possibly heterogeneous) engine replicas using the paper's
estimator: each replica is a "helper", a batch is a "packet", and dispatch
rates follow E[beta] estimates with timeout backoff — the serving-side
realization of Algorithm 1.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import _device
from ..core.scheduler import CCPScheduler
from ..models.model import Model


@dataclasses.dataclass
class ServeEngine:
    """Greedy generation on ``device`` (CUDA unless the caller names
    another; ``params`` must live there).  The KV cache is allocated per
    call (``max_len`` slots) and written in place; the generated tokens stay
    on the device until the last step, so the decode loop makes no host
    sync of its own."""

    model: Model
    params: object
    max_len: int = 512
    sample: str = "greedy"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.sample != "greedy":
            raise ValueError(f"sample={self.sample!r}: only greedy decoding is ported")
        self.device = _device.resolve(self.device)
        _device.full_fp32_matmuls(self.device)

    @torch.no_grad()
    def generate(
        self,
        tokens: np.ndarray,           # (B, T) prompts (right-aligned, padded)
        n_new: int,
        embeds: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Prefill ``tokens[:, :-1]``, then decode ``n_new`` tokens from the
        last prompt token by argmax; returns them as a (B, n_new) int32
        array, as the reference does."""
        B, T = tokens.shape
        cache = self.model.init_cache(B, self.max_len, device=self.device)
        toks = torch.as_tensor(np.asarray(tokens, dtype=np.int32), device=self.device)
        emb = None if embeds is None else torch.as_tensor(np.asarray(embeds), device=self.device)
        _, cache = self.model.prefill(self.params, toks[:, :-1], cache, emb)
        out = []
        cur = toks[:, -1:]
        for _ in range(n_new):
            logits, cache = self.model.decode_step(self.params, cur, cache)
            cur = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            out.append(cur)
        if not out:
            return np.zeros((B, 0), np.int32)
        return torch.cat(out, dim=1).cpu().numpy()


class CCPDispatcher:
    """Dispatch request batches over replicas with eq. (23) allocation."""

    def __init__(self, replicas: Sequence[Callable[[np.ndarray], np.ndarray]]):
        self.replicas = list(replicas)
        self.sched = CCPScheduler(n_workers=len(self.replicas))

    def run(self, batches: List[np.ndarray], rounds: Optional[int] = None):
        """Process batches round-by-round; per round, allocation follows the
        current E[beta] estimates. Returns (results, per_round_alloc).  A
        replica's time covers its whole share of the round, ending in its
        result on the host (``generate`` copies it there)."""
        results = [None] * len(batches)
        allocs = []
        i = 0
        while i < len(batches):
            n_left = len(batches) - i
            alloc = self.sched.allocation(min(n_left, len(self.replicas) * 4))
            allocs.append(alloc.copy())
            durations = np.zeros(len(self.replicas))
            for w, n_w in enumerate(alloc):
                t0 = time.perf_counter()
                for _ in range(int(n_w)):
                    if i >= len(batches):
                        break
                    results[i] = self.replicas[w](batches[i])
                    i += 1
                durations[w] = time.perf_counter() - t0
            # feed only workers that actually ran something this round
            obs = np.where(alloc > 0, durations / np.maximum(alloc, 1), np.nan)
            obs = np.where(np.isnan(obs), np.nanmean(obs), obs)
            self.sched._work = np.maximum(alloc, 1)
            self.sched.observe_step(obs * np.maximum(alloc, 1))
        return results, allocs
