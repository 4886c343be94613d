"""State carried across from the JAX package, as numpy arrays only.

The port cannot reproduce ``jax.random`` draws, and its numpy code
construction is a copy, so these constructors let a test hand the port the
exact objects the reference built: an LT code or a coded-matmul plan from
the reference's tables, and helper/packet tables the reference drew.  In
this system they play the part that model weights play elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _device
from .core import engine, fountain
from .core.coded_matmul import CodedMatmulPlan

__all__ = ["lt_code_from_arrays", "plan_from_arrays", "tables_from_numpy"]


def lt_code_from_arrays(idx, mask, coef, R: int, K: int) -> fountain.LTCode:
    """An :class:`~repro_torch.core.fountain.LTCode` with the given tables,
    in the reference's dtypes (int32 / bool / float32)."""
    return fountain.LTCode(
        idx=np.asarray(idx, dtype=np.int32),
        mask=np.asarray(mask, dtype=bool),
        coef=np.asarray(coef, dtype=np.float32),
        R=int(R), K=int(K),
    )


def plan_from_arrays(idx, mask, coef, R: int, K: int, n_shards: int,
                     placement, bm: int) -> CodedMatmulPlan:
    """A coded-matmul plan equal to the reference plan with these tables."""
    return CodedMatmulPlan(
        code=lt_code_from_arrays(idx, mask, coef, R, K),
        n_shards=int(n_shards),
        placement=np.asarray(placement, dtype=np.int64),
        bm=int(bm),
    )


def tables_from_numpy(mu, a, rate, beta, d_up, d_ack, d_down,
                      device=None) -> engine.Tables:
    """Engine tables from reference draws: helper arrays (B, N) and packet
    tables (B, N, M), cast to float32 on ``device`` (CUDA by default).

    The cast matters: a float64 numpy array would stay float64 in torch
    and break parity with the reference, whose tables are float32."""
    dev = _device.resolve(device)

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=dev)

    tables = engine.Tables(t(mu), t(a), t(rate), t(beta), t(d_up), t(d_ack),
                           t(d_down))
    if tables.mu.dim() != 2 or tables.beta.dim() != 3:
        raise ValueError("need helper arrays (B, N) and packet tables (B, N, M); "
                         f"got {tuple(tables.mu.shape)} and {tuple(tables.beta.shape)}")
    return tables
