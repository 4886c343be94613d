"""Public entry of the LT payload decode: device dispatch and plan plumbing
(port of ``repro.kernels.lt_decode.ops``).

``lt_decode`` takes the received coded blocks and a peeling
:class:`~repro_torch.core.fountain.DecodePlan`.  On CUDA tensors it fills
the degree-1 (direct) receipts with torch indexing (a scaled gather, not a
kernel), then makes one :func:`~.kernel.lt_decode_round_cuda` launch per
:func:`~repro_torch.core.fountain.plan_rounds` level, each writing straight
into the source buffer.  The schedule is built on the host before the first
launch and copied to the card in one piece, so the rounds need no host
synchronisation between them.  On CPU tensors it runs the plain version
``ref.lt_decode_ref``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core import fountain
from .kernel import lt_decode_round_cuda
from .ref import lt_decode_ref


def lt_decode(
    coded_rx: torch.Tensor,
    plan: fountain.DecodePlan,
    *,
    bm: int,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Recover the source rows from received coded rows via peeling.

    coded_rx: (n_rx * bm, n_cols), the received coded blocks in the order of
    the ``received_ids`` the plan was built from.  Returns (R * bm, n_cols)
    in coded_rx's type.  ``use_kernel`` defaults to the device, as in
    :func:`repro_torch.kernels.lt_encode.lt_encode`.
    """
    if coded_rx.shape[0] % bm:
        raise ValueError(f"coded_rx rows {coded_rx.shape[0]} not divisible by bm={bm}")
    if use_kernel is None:
        use_kernel = coded_rx.is_cuda
    if use_kernel != coded_rx.is_cuda:
        raise ValueError(
            f"use_kernel={use_kernel} but coded_rx is on {coded_rx.device}: the "
            "kernel runs on CUDA tensors and the plain version on CPU tensors")
    if not use_kernel:
        return lt_decode_ref(coded_rx, plan, bm=bm)
    R, n_cols, dev = plan.R, coded_rx.shape[1], coded_rx.device
    n_rx = coded_rx.shape[0] // bm
    rounds = fountain.plan_rounds(plan)
    for name, v, hi in (("direct_coded", plan.direct_coded, n_rx),
                        ("direct_src", plan.direct_src, R),
                        ("order_coded", plan.order_coded, n_rx),
                        ("order_src", plan.order_src, R),
                        ("order_nbr_idx", plan.order_nbr_idx, R)):
        if v.size and (v.min() < 0 or v.max() >= hi):
            raise ValueError(f"plan.{name} indexes outside [0, {hi})")
    coded = coded_rx.contiguous()
    src = torch.zeros((R * bm, n_cols), dtype=coded.dtype, device=dev)
    if plan.direct_src.size:
        # Degree-1 receipts are plain scaled copies: a gather, not a kernel.
        dcoef = torch.as_tensor(plan.direct_coef, device=dev).to(src.dtype)[:, None, None]
        src.view(R, bm, n_cols)[torch.as_tensor(plan.direct_src, device=dev).long()] = (
            coded.view(n_rx, bm, n_cols)[torch.as_tensor(plan.direct_coded, device=dev).long()]
            / dcoef)
    if not rounds:
        return src
    # Every round's schedule in one host-to-device copy per field.
    cat = lambda f: np.concatenate([getattr(r, f) for r in rounds])  # noqa: E731
    ints = torch.as_tensor(np.concatenate(
        [cat("coded"), cat("src"), cat("nbr_idx").ravel()]).astype(np.int32), device=dev)
    floats = torch.as_tensor(np.concatenate(
        [cat("nbr_coef").ravel(), 1.0 / cat("pivot")]).astype(np.float32), device=dev)
    T, d_max = plan.n_peeled, plan.order_nbr_idx.shape[1]
    cpos, dst, idx = ints[:T], ints[T:2 * T], ints[2 * T:].view(T, d_max)
    w, inv_pivot = floats[:T * d_max].view(T, d_max), floats[T * d_max:]
    s0 = 0
    for rnd in rounds:
        s1 = s0 + rnd.size
        lt_decode_round_cuda(coded, src, cpos[s0:s1], dst[s0:s1], idx[s0:s1],
                             w[s0:s1], inv_pivot[s0:s1], bm)
        s0 = s1
    return src


def lt_decode_code(
    coded_rx: torch.Tensor,
    code: fountain.LTCode,
    received_ids: np.ndarray,
    *,
    bm: Optional[int] = None,
    **kw,
) -> torch.Tensor:
    """Plan-and-decode convenience: peel ``received_ids`` of ``code`` and
    apply.  Raises when peeling stalls (the caller falls back to
    :func:`repro_torch.core.fountain.decode`'s dense solve)."""
    plan = fountain.peel_decode_plan(code, received_ids)
    if plan is None:
        raise ValueError(
            "peeling stalled on the received set; use fountain.decode for "
            "the dense fallback")
    if bm is None:
        n_rx = len(np.asarray(received_ids))
        if coded_rx.shape[0] % n_rx:
            raise ValueError(
                f"coded_rx rows {coded_rx.shape[0]} not divisible by n_rx={n_rx}")
        bm = coded_rx.shape[0] // n_rx
    return lt_decode(coded_rx, plan, bm=bm, **kw)
