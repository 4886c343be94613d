"""Plain PyTorch version of the round-based LT payload decode.

The offline :func:`repro_torch.core.fountain.apply_decode_plan` walks the
peeling schedule one source at a time.  The kernel path instead executes
the :func:`repro_torch.core.fountain.plan_rounds` levelization: every source
of a round is recovered by one batched masked gather + subtract, so the
critical path is the dependency depth rather than the step count.  This
module mirrors ``repro.kernels.lt_decode.ref`` (sums in the data's type,
padding slots multiplied by their 0 weight); the CUDA kernel (K3) is held
against it, and it is what a CPU tensor runs.
"""

from __future__ import annotations

import torch

from ...core import fountain


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
