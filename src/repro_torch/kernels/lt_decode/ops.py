"""Public entry of the LT payload decode: device dispatch and plan plumbing
(port of ``repro.kernels.lt_decode.ops``).

``lt_decode`` takes the received coded blocks and a peeling
:class:`~repro_torch.core.fountain.DecodePlan`.  On CUDA tensors it fills
the degree-1 (direct) receipts with torch indexing (a gather, not a
kernel), then makes one :func:`~.kernel.lt_decode_plan_cuda` launch that
walks every peeled step of the plan in round order, writing straight into
the source buffer.  The schedule (``schedule.plan_program``, or
``schedule.scan_program`` for ``scan=True``) and the direct fills' indices
are built on the host and copied to the card in one piece.  On CPU tensors
it runs the plain version ``ref.lt_decode_ref`` (``scan=True``:
``fountain.apply_decode_plan``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core import fountain
from .. import _nvcc
from . import schedule
from .kernel import lt_decode_plan_cuda
from .ref import lt_decode_ref


def lt_decode(
    coded_rx: torch.Tensor,
    plan: fountain.DecodePlan,
    *,
    bm: int,
    use_kernel: Optional[bool] = None,
    scan: bool = False,
) -> torch.Tensor:
    """Recover the source rows from received coded rows via peeling.

    coded_rx: (n_rx * bm, n_cols), the received coded blocks in the order of
    the ``received_ids`` the plan was built from.  Returns (R * bm, n_cols)
    in coded_rx's type.  ``use_kernel`` defaults to the device, as in
    :func:`repro_torch.kernels.lt_encode.lt_encode`; a CUDA tensor of a type
    the kernel does not take (float32, bfloat16) raises.

    The default runs the plan's rounds as the reference's round kernel
    does: a padding slot (zero weight) reads its block as it stood before
    the entry's round, so a non-finite value there gives NaN only from the
    next round on.  ``scan=True`` runs the steps in plan order as
    :func:`~repro_torch.core.fountain.apply_decode_plan` (the reference's
    ``fountain.decode``) does: a padding slot reads its block as the
    previous step left it.  The two differ only where a padding-named block
    is non-finite.
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
        if scan:
            n_cols = coded_rx.shape[1]
            return fountain.apply_decode_plan(coded_rx.reshape(-1, bm * n_cols),
                                              plan).view(plan.R * bm, n_cols)
        return lt_decode_ref(coded_rx, plan, bm=bm)
    if coded_rx.dtype not in _nvcc.DTYPE_CODE:
        raise ValueError(f"lt_decode on the card takes {list(_nvcc.DTYPE_CODE)}; "
                         f"got {coded_rx.dtype}")
    R, n_cols, dev = plan.R, coded_rx.shape[1], coded_rx.device
    n_rx = coded_rx.shape[0] // bm
    for name, v, hi in (("direct_coded", plan.direct_coded, n_rx),
                        ("direct_src", plan.direct_src, R),
                        ("order_coded", plan.order_coded, n_rx),
                        ("order_src", plan.order_src, R),
                        ("order_nbr_idx", plan.order_nbr_idx, R)):
        if v.size and (v.min() < 0 or v.max() >= hi):
            raise ValueError(f"plan.{name} indexes outside [0, {hi})")
    if plan.order_nbr_idx.shape[1] > _nvcc.MAX_D:
        raise ValueError(f"d_max={plan.order_nbr_idx.shape[1]} exceeds the kernel's "
                         f"{_nvcc.MAX_D} slots")
    coded = coded_rx.contiguous()
    # Every block is written below when the plan recovers all R, so the
    # buffer needs no zero fill then.
    covered = np.union1d(plan.direct_src, plan.order_src).size == R
    src = (torch.empty if covered else torch.zeros)((R * bm, n_cols), dtype=coded.dtype,
                                                     device=dev)
    words = (schedule.scan_program if scan else schedule.plan_program)(plan, n_rx)
    D = plan.direct_src.size
    # The program, then the direct fills' source and coded positions, in one
    # host-to-device copy (the program's words first, so it starts aligned).
    host = np.concatenate([words.view(np.int64),
                           plan.direct_src.astype(np.int64), plan.direct_coded.astype(np.int64)])
    ints = torch.as_tensor(host, device=dev)
    if D:
        # Degree-1 receipts are scaled copies: a gather, not a kernel.
        dsrc, dcoded = ints[words.size // 2:words.size // 2 + D], ints[words.size // 2 + D:]
        got = coded.view(n_rx, bm, n_cols).index_select(0, dcoded)
        if not (plan.direct_coef == 1).all():  # x / 1 == x: skip the pass
            got /= torch.as_tensor(plan.direct_coef, device=dev).to(src.dtype)[:, None, None]
        src.view(R, bm, n_cols).index_copy_(0, dsrc, got)
    if words.size:
        lt_decode_plan_cuda(coded, src, ints[:words.size // 2].view(torch.int32), bm)
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
