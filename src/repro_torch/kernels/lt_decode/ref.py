"""Plain PyTorch versions of the round-based LT payload decode.

The offline :func:`repro_torch.core.fountain.apply_decode_plan` walks the
peeling schedule one source at a time.  The kernel path instead executes
the :func:`repro_torch.core.fountain.plan_rounds` levelization: every source
of a round is recovered by one batched masked gather + subtract, so the
critical path is the dependency depth rather than the step count.
``peel_round_ref`` and ``lt_decode_ref`` mirror ``repro.kernels.lt_decode.ref``
(sums in the data's type, padding slots multiplied by their 0 weight); the
CUDA kernel (K3) is held against them, and they are what a CPU tensor runs.
``lt_decode_program_ref`` is the plain version of the kernel's own
interface, the program of ``schedule.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import fountain
from . import schedule


def peel_round_ref(src: torch.Tensor, coded: torch.Tensor, rnd: fountain.PlanRound,
                   *, bm: int) -> torch.Tensor:
    """Apply one :class:`~repro_torch.core.fountain.PlanRound` to the source
    buffer.

    src:   (R, bm, n_cols) partially recovered source blocks.
    coded: (n_rx, bm, n_cols) received coded blocks.
    Returns the (S, bm, n_cols) newly recovered blocks for ``rnd.src``.
    """
    dev, dt = src.device, src.dtype
    gathered = src[torch.as_tensor(rnd.nbr_idx, device=dev).long()]  # (S, d_max, bm, cols)
    w = torch.as_tensor(rnd.nbr_coef, device=dev).to(dt)[:, :, None, None]
    piv = torch.as_tensor(rnd.pivot, device=dev).to(dt)[:, None, None]
    c = coded[torch.as_tensor(rnd.coded, device=dev).long()]
    return (c - (gathered * w).sum(dim=1)) / piv


def lt_decode_ref(coded_rx: torch.Tensor, plan: fountain.DecodePlan,
                  *, bm: int) -> torch.Tensor:
    """Round-based peeling decode: (n_rx * bm, n_cols) -> (R * bm, n_cols)."""
    n_cols, dev = coded_rx.shape[1], coded_rx.device
    n_rx = coded_rx.shape[0] // bm
    coded = coded_rx.reshape(n_rx, bm, n_cols)
    src = torch.zeros((plan.R, bm, n_cols), dtype=coded_rx.dtype, device=dev)
    if plan.direct_src.size:
        dcoef = torch.as_tensor(plan.direct_coef, device=dev).to(src.dtype)[:, None, None]
        src[torch.as_tensor(plan.direct_src, device=dev).long()] = (
            coded[torch.as_tensor(plan.direct_coded, device=dev).long()] / dcoef)
    for rnd in fountain.plan_rounds(plan):
        src[torch.as_tensor(rnd.src, device=dev).long()] = peel_round_ref(src, coded, rnd, bm=bm)
    return src.reshape(plan.R * bm, n_cols)


def lt_decode_program_ref(coded: torch.Tensor, src: torch.Tensor, program, *,
                          bm: int) -> torch.Tensor:
    """Run a program of ``schedule.py`` on ``coded`` (n_rx * bm, cols) into
    ``src`` (R * bm, cols), in place, as :func:`lt_decode_ref` runs a plan's
    rounds: each round from ``src`` as it stood before it, the sum over the
    round's ``width`` slots in the data's type, then times ``inv_pivot``, and
    NaN where a padding block the entry names held a non-finite value before
    the round.  Equal to :func:`lt_decode_ref` bit for bit where the nonzero
    weights lead each slot row and the pivots are +-1, as in the plans of
    :func:`~repro_torch.core.fountain.peel_decode_plan`.  A program of
    ``schedule.scan_program`` (one entry a round) is the sequential walk of
    :func:`~repro_torch.core.fountain.apply_decode_plan`.  Blocks the
    program does not read may hold anything."""
    n_cols, dev, dt = src.shape[1], src.device, src.dtype
    c3 = coded.reshape(-1, bm, n_cols)
    s3 = src.view(-1, bm, n_cols)
    R, n_rx = s3.shape[0], c3.shape[0]
    words = program.cpu().numpy() if torch.is_tensor(program) else np.asarray(program)
    for rnd in schedule.read_program(words):
        ents = [e for e in rnd.entries if 0 <= e.cpos < n_rx and 0 <= e.dst < R]
        if not ents:
            continue
        bad = [~torch.isfinite(s3[int(b)]) for b in rnd.padding]
        width = max([rnd.width] + [e.idx.size for e in ents])
        gathered = torch.zeros((len(ents), width, bm, n_cols), dtype=dt, device=dev)
        wts = torch.zeros((len(ents), width), dtype=torch.float32)
        for s, e in enumerate(ents):
            ok = (e.idx >= 0) & (e.idx < R)
            k = int(ok.sum())
            gathered[s, :k] = s3[torch.as_tensor(e.idx[ok], device=dev).long()]
            wts[s, :k] = torch.as_tensor(e.w[ok])
        inv = torch.tensor([e.inv_pivot for e in ents], dtype=torch.float32)
        vals = (c3[torch.tensor([e.cpos for e in ents], device=dev)]
                - (gathered * wts.to(dev, dt)[:, :, None, None]).sum(dim=1)
                ) * inv.to(dev, dt)[:, None, None]
        for s, e in enumerate(ents):
            for q, b in enumerate(bad):
                if e.padmask >> q & 1:
                    vals[s][b] = torch.nan
        s3[torch.tensor([e.dst for e in ents], device=dev)] = vals
    return src
