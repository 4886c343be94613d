"""Fountain-coded matmul: plan, helpers' coded products, and recovery.

The paper's end-to-end object: y = A x computed by N workers holding
fountain-coded row-blocks, tolerant to any K worker losses.  Each shard
holds a slice of the coded block space (systematic blocks + parities
interleaved round-robin so losing a shard loses a *spread* of blocks, not a
contiguous run); a lost shard is modeled by a survivor set and the collector
recovers y by peeling/dense decode.

Port of ``repro.core.coded_matmul``.  ``plan_coded_matmul`` is copied
verbatim (numpy RNG and rank checks), so the code, the placement and the
validated seed equal the reference's.  Without a mesh, :func:`run` is a
single launch of the fused kernel over all coded blocks in shard-major
placement order.  With a mesh (:func:`repro_torch.launch.mesh.make_host_mesh`)
it is the reference's ``shard_map`` branch: each device along the axis
encodes and multiplies only its own blocks, one launch a device (the
paper's helpers), and the results come back shard-major on the first
device, where the collector runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.coded_matmul import coded_matmul as coded_matmul_op
from . import fountain

__all__ = ["CodedMatmulPlan", "plan_coded_matmul", "device_blocks", "run", "recover"]


@dataclasses.dataclass(frozen=True)
class CodedMatmulPlan:
    """Static plan: code + device->coded-block placement for n_shards."""

    code: fountain.LTCode
    n_shards: int
    placement: np.ndarray      # (n_shards, blocks_per_shard) coded ids
    bm: int                    # rows per block

    @property
    def blocks_per_shard(self) -> int:
        return self.placement.shape[1]


def plan_coded_matmul(
    rows: int, n_shards: int, overhead: float = 0.25, bm: int = 128,
    seed: int = 0, validate_losses: int = 1, max_tries: int = 50,
) -> CodedMatmulPlan:
    """Split an (rows x k) matrix into bm-row blocks, build a systematic LT
    code with ~``overhead`` parities rounded so every shard holds the same
    block count, and place blocks round-robin across shards.

    Placement-aware validation: on a mesh the unit of failure is a *shard*
    (a whole device's blocks at once), so the plan is rank-checked against
    every loss pattern of up to ``validate_losses`` shards and re-seeded
    until all decode — turning the fountain code's probabilistic contract
    into a deterministic per-plan guarantee (cf. Raptor pre-validation)."""
    if rows % bm:
        raise ValueError(f"rows={rows} not divisible by bm={bm}")
    R = rows // bm
    K = int(np.ceil(R * overhead))
    total = R + K
    if total % n_shards:  # pad K so shards are uniform
        K += n_shards - total % n_shards
    ids = np.arange(R + K)
    placement = np.stack([ids[s::n_shards] for s in range(n_shards)])

    import itertools

    last_err = None
    for t in range(max_tries):
        # dense ±1 parities: encode adds are VPU-cheap next to the fused
        # MXU matmul, and small-block shard-loss patterns become
        # generically full-rank (see fountain.make_lt_code docstring)
        code = fountain.make_lt_code(
            R, K, seed=seed + 7919 * t, parity_degree=max(R // 2, 4)
        )
        if validate_losses <= 0:
            return CodedMatmulPlan(code, n_shards, placement, bm)
        G = code.dense_generator()
        ok = True
        for r in range(1, validate_losses + 1):
            for lost in itertools.combinations(range(n_shards), r):
                keep = np.setdiff1d(np.arange(n_shards), lost)
                rx = placement[keep].reshape(-1)
                if np.linalg.matrix_rank(G[rx]) < R:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return CodedMatmulPlan(code, n_shards, placement, bm)
        last_err = f"seed {seed + 7919 * t} fails a {r}-shard loss pattern"
    raise ValueError(
        f"no code tolerating {validate_losses}-shard losses found in "
        f"{max_tries} tries (R={R}, K={K}, shards={n_shards}); raise the "
        f"overhead. Last: {last_err}"
    )


def device_blocks(plan: CodedMatmulPlan, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard (idx, weights) tables in placement order, on a's device:
    returns (idx (S*Bp, d_max) int32, weights (S*Bp, d_max) float32) where
    row s*Bp+i is the i-th coded block on shard s (weights = mask *
    Rademacher coef, the kernel's float coefficient operand)."""
    flat = plan.placement.reshape(-1)
    return (
        torch.as_tensor(plan.code.idx[flat], device=a.device),
        torch.as_tensor(plan.code.weights[flat], device=a.device),
    )


def run(
    plan: CodedMatmulPlan,
    a: torch.Tensor,             # (rows, k_dim) source matrix
    x: torch.Tensor,             # (k_dim, n_dim)
    mesh=None,
    axis: str = "model",
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Compute all coded block products, laid out shard-major:
    out[s*Bp+i] = (G A)[placement[s, i]] @ x, shape (S*Bp*bm, n_dim).

    Without a mesh, one call of the fused coded matmul over every shard's
    blocks (the kernel on CUDA tensors, its plain version on CPU tensors).
    With one, the coded blocks split evenly over the devices along
    ``axis`` (shard s on the s-th device when the axis has ``n_shards``
    of them): each device gets A and X (the same tensors where they are
    already there) and computes only its blocks in one call; the pieces
    are joined in order on the first device."""
    idx, weights = device_blocks(plan, a)
    if mesh is None:
        return coded_matmul_op(a, x, idx, weights, bm=plan.bm, use_kernel=use_kernel)
    devs = mesh.axis_devices(axis)
    rows = idx.shape[0]
    if rows % len(devs):
        raise ValueError(f"{rows} coded blocks do not split over the {len(devs)} devices of "
                         f"mesh axis {axis!r}")
    per = rows // len(devs)
    parts = []
    for d, dev in enumerate(devs):
        blocks = slice(d * per, (d + 1) * per)
        parts.append(coded_matmul_op(a.to(dev), x.to(dev), idx[blocks].to(dev),
                                     weights[blocks].to(dev), bm=plan.bm,
                                     use_kernel=use_kernel))
    return torch.cat([p.to(devs[0]) for p in parts])


def recover(
    plan: CodedMatmulPlan,
    out: torch.Tensor,           # (S*Bp*bm, n_dim) coded results
    survivors: np.ndarray,       # shard ids that returned
) -> torch.Tensor:
    """Collector-side recovery of y = A x from surviving shards only."""
    Bp, bm = plan.blocks_per_shard, plan.bm
    rows = []
    ids = []
    for s in survivors:
        s = int(s)
        sl = out[s * Bp * bm : (s + 1) * Bp * bm]
        rows.append(sl.reshape(Bp, bm, -1))
        ids.extend(plan.placement[s].tolist())
    coded_rx = torch.cat(rows, dim=0)  # (n_rx, bm, n_dim)
    dec, _ = fountain.decode(coded_rx, plan.code, np.asarray(ids))
    return dec.reshape(plan.code.R * bm, -1)
