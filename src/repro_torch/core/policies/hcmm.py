"""HCMM baseline (arXiv:1701.05973, Reisizadeh et al.) as an in-loop policy.

Each helper gets a fixed block of MDS-coded rows, sized by the
asymptotically-optimal load; the collector finishes when the loads of
*fully finished* helpers sum to >= R.  Load solver (vectorized Newton):
helper n's per-time expected useful rate is
``rho(lmbda) = lmbda * (1 - e^{mu a - mu/lmbda})``; the optimum ``lmbda*``
solves ``ln(1 + u + mu*a) = u`` with ``u = mu/lmbda - mu*a``, then
``tau* = R / sum_n rho_n(lmbda_n*)`` and ``ell_n = lmbda_n* tau*``.

Port of ``repro.core.policies.hcmm`` on a leading rep dimension (B, N),
float32.  The stream and timing model are
:class:`~.uncoded.UncodedPolicy`'s; only the loads and the completion rule
differ.
"""

from __future__ import annotations

import dataclasses

import torch

from ..simulator import _rdiv
from .base import register
from .uncoded import UncodedPolicy, block_finish_times, ordered_sum, largest_remainder_round


def u_star(mu_a: torch.Tensor) -> torch.Tensor:
    """Solve ``ln(1 + u + mu*a) = u`` for u > 0, elementwise: exactly 64
    Newton iterations (converged lanes sit at a fixed point)."""
    u = torch.clamp_min(mu_a, 1.0)
    for _ in range(64):
        f = torch.log1p(u + mu_a) - u
        fp = _rdiv(1.0, 1.0 + u + mu_a) - 1.0
        # fp underflows to exactly 0 in f32 once u + mu_a < ~1e-7 (a mu = 0
        # lane), and f is 0 there too: hold the fixed point instead of 0/0.
        fp_safe = torch.where(fp < 0, fp, -1.0)
        u_new = torch.where(fp < 0, u - f / fp_safe, u)
        u = torch.where(u_new <= 0, u / 2.0, u_new)
    return u


def hcmm_loads(R: int, mu: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """HCMM asymptotically-optimal int32 loads (B, N) per rep."""
    mu_a = mu * a
    u = u_star(mu_a)
    lam = mu / (u + mu_a)
    rho = lam * (1.0 - torch.exp(-u))
    tau = _rdiv(float(R), ordered_sum(rho))
    loads = lam * tau[..., None]
    return largest_remainder_round(loads, torch.ceil(ordered_sum(loads)))


@register
@dataclasses.dataclass(frozen=True)
class HCMMPolicy(UncodedPolicy):
    """Fixed MDS blocks, completion at aggregate finished load >= R."""

    name = "hcmm"
    version = 1

    def prepare(self, cfg, R: int, ccp_cfg, mu, a, rate) -> dict:
        return {"loads": hcmm_loads(R, mu, a)}

    def finalize(self, outs, aux, cfg, R: int, kk: int, tx_end):
        loads = aux["loads"]
        t_n = block_finish_times(outs, loads)
        order = torch.argsort(t_n, dim=-1, stable=True)
        agg = torch.cumsum(torch.gather(loads, -1, order), dim=-1, dtype=torch.int32)
        target = torch.full((agg.shape[0], 1), R, dtype=torch.int32, device=agg.device)
        pos = torch.searchsorted(agg, target).clamp(0, loads.shape[-1] - 1)
        valid = loads.amax(dim=-1) <= outs["tr"].shape[-1]
        return torch.gather(torch.gather(t_n, -1, order), -1, pos)[:, 0], valid
