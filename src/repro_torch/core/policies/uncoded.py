"""Uncoded baseline (paper §6) as an in-loop policy.

``r_n`` *uncoded* packets are pre-assigned to helper ``n`` (summing to
exactly R: no coding, so *every* helper must finish its block).  Two
allocation rules from the paper: proportional to 1/E[beta_n] ('mean') and
proportional to mu_n ('mu').

Port of ``repro.core.policies.uncoded`` on a leading rep dimension: loads
are (B, N) int32, traces (B, N, M), arithmetic float32 as the reference's.
The stream is back-to-back uplink serialization (tx_{i+1} = tx_i + d_up_i),
the completion rule is ``max_n Tr_{n, loads_n}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import simulator
from ..simulator import _rdiv  # num / t as one float32 division, as the reference
from .base import Policy, StepCtx, register


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of XLA's CPU reduction, the same
    bits on every device.  Up to 32 terms: a left fold.  Beyond: the axis
    is zero-padded to a multiple of 32, the padding split evenly before and
    after (the extra element after), each window of 32 is a left fold, and
    the window sums are summed the same way.  ``torch.sum``'s order differs
    from it and between the CPU and CUDA, and one ulp of a load can move a
    largest-remainder tie or HCMM's ``ceil`` of the loads' total."""
    n = x.shape[-1]
    if n > 32:
        p = -(-n // 32) * 32
        lo = (p - n) // 2
        x = torch.nn.functional.pad(x, (lo, p - n - lo)).reshape(*x.shape[:-1], p // 32, 32)
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc if n <= 32 else ordered_sum(acc)


def largest_remainder_round(loads: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Largest-remainder rounding per rep: non-negative real ``loads``
    (B, N) -> int32 loads summing exactly to ``total`` (B,).  Ties break by
    helper index (a stable sort of ``-frac``, as ``jnp.argsort`` is)."""
    base = torch.floor(loads)
    short = (torch.round(total) - base.sum(dim=-1)).to(torch.int32)
    frac = loads - base
    order = torch.argsort(-frac, dim=-1, stable=True)
    bump = (torch.arange(loads.shape[-1], device=loads.device) < short[..., None]).to(base.dtype)
    add = torch.zeros_like(base).scatter(-1, order, bump)
    return (base + add).to(torch.int32)


def block_finish_times(outs, loads: torch.Tensor) -> torch.Tensor:
    """Per-helper block finish time (B, N) from the loop's traces: the Tr of
    the last assigned packet, +inf if any packet of the block was lost, or
    0 for an empty block."""
    tr = outs["tr"]
    m = tr.shape[-1]
    mask = torch.arange(m, device=tr.device) < loads[..., None]
    idx = torch.clamp(loads.long() - 1, 0, m - 1)
    t_last = torch.gather(tr, -1, idx[..., None])[..., 0]
    lost_any = (mask & ~torch.isfinite(tr)).any(dim=-1)
    return torch.where(loads > 0, torch.where(lost_any, torch.inf, t_last), 0.0)


@dataclasses.dataclass(frozen=True)
class UncodedPolicy(Policy):
    rule: str = "mean"
    version = 1
    m_cap_factor = 4
    report_aux = ("loads",)
    # Fixed pre-assigned blocks go over each tenant's recruited helpers, not
    # the whole pool: a block stranded on a stream that never sends would
    # make the task unfinishable.
    fleet_aux = "per_task"

    @property
    def name(self) -> str:
        return f"uncoded_{self.rule}"

    def prepare(self, cfg, R: int, ccp_cfg, mu, a, rate) -> dict:
        if self.rule == "mean":
            w = _rdiv(1.0, a + _rdiv(1.0, mu))
        elif self.rule == "mu":
            w = mu
        else:
            raise ValueError(f"unknown uncoded rule {self.rule!r}")
        total = torch.full(w.shape[:-1], float(R), device=w.device)
        return {"loads": largest_remainder_round(R * w / ordered_sum(w)[..., None], total)}

    def horizon_hint(self, cfg, R: int, kk: int):
        """Block policies send ~R/N packets per helper: hint the expected
        largest block (the fastest helper class's share of R under this
        policy's own weights) with headroom, bucketed to a power of two.  A
        draw whose block exceeds it fails certification and the engine
        doubles M."""
        mu, _a, w_mean = simulator.class_weights(cfg)
        w = mu if self.rule == "mu" else w_mean
        share = float(w.max() / (cfg.N * w.mean()))
        m = int(np.ceil(1.5 * kk * share)) + 32
        return 1 << int(np.ceil(np.log2(max(m, 32))))

    def next_load(self, state, ctx: StepCtx):
        # Back-to-back uplink: send packet i+1 the moment packet i's
        # transmission finishes.
        return ctx.tx + ctx.d_up

    def on_timeout(self, state, ctx: StepCtx, tx_next):
        # No ARQ: a lost packet is simply gone; keep streaming the block.
        return state, ctx.tx + ctx.d_up

    def packet_mask(self, aux, n: int, m: int):
        loads = aux["loads"]
        return torch.arange(m, device=loads.device) < loads[..., None]

    def finalize(self, outs, aux, cfg, R: int, kk: int, tx_end):
        t_n = block_finish_times(outs, aux["loads"])
        valid = aux["loads"].amax(dim=-1) <= outs["tr"].shape[-1]
        return t_n.amax(dim=-1), valid


register("uncoded_mean", factory=UncodedPolicy)
register("uncoded_mu", factory=lambda: UncodedPolicy(rule="mu"))
