"""Quickstart: one C3P task end to end on the port.

1. Simulate CCP against the oracle Best on the paper's Scenario-1 setup
   (Fig. 3a: N=100, R=2000) over 200 reps, beside the eq. (27) optimum.
2. Run a fountain-coded distributed matmul, lose each shard in turn, and
   recover y = A x from the survivors.

    PYTHONPATH=src python -m repro_torch.quickstart                # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu

The port's counterpart of ``examples/quickstart.py``, without the
uncoded/HCMM baselines (a later slice).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import _device
from .configs.ccp_paper import FIG3, REPS
from .core import coded_matmul, engine, theory


def ccp_vs_best(device=None, R: int = 2000, reps: int = REPS, seed: int = 0) -> dict:
    """Mean completion time of CCP and Best on the same draws, the mean
    eq. (27) optimum of those draws, and CCP's mean helper efficiency."""
    cfg = FIG3[1]
    eng = engine.Engine(device=device)
    print(f"== CCP vs Best (paper Fig. 3a setup, R={R}, {reps} reps, "
          f"{eng.device}) ==")
    t0 = time.perf_counter()
    res = {name: eng.run(cfg, name, reps, R, seed=seed) for name in ("ccp", "best")}
    wall = time.perf_counter() - t0
    ccp = res["ccp"]
    mu, a = ccp.mu.cpu().numpy(), ccp.a.cpu().numpy()
    t_opt = float(np.mean([theory.t_opt_model1(R, cfg.K(R), a[r], mu[r])
                           for r in range(reps)]))
    out = dict(
        T_ccp=float(ccp.T.mean()), T_best=float(res["best"].T.mean()),
        T_opt=t_opt, efficiency=float(torch.nanmean(ccp.efficiency)),
        valid=all(bool(r.valid.all()) for r in res.values()),
        M={name: r.M for name, r in res.items()}, wall_s=wall,
    )
    print(f"  T_ccp      = {out['T_ccp']:8.2f}s")
    print(f"  T_best     = {out['T_best']:8.2f}s")
    print(f"  T_optimum  = {out['T_opt']:8.2f}s   (eq. 27)")
    print(f"  mean helper efficiency: {out['efficiency']:.2%}   "
          f"all reps certified: {out['valid']}   wall {wall:.2f}s\n")
    return out


def coded_offload(device=None, rows: int = 256, k_dim: int = 64, n_dim: int = 32,
                  n_shards: int = 4, overhead: float = 0.5, bm: int = 16,
                  seed: int = 0) -> dict:
    """Plan, compute every shard's coded products, then recover y = A x with
    all shards and with each single shard lost; reports max|y - A x| and
    its ratio to max|A x| for each survivor set."""
    dev = _device.resolve(device)
    print(f"== Coded distributed matmul ({rows}x{k_dim} @ {k_dim}x{n_dim}, "
          f"{n_shards} shards, {dev}): lose a shard, still finish ==")
    plan = coded_matmul.plan_coded_matmul(rows=rows, n_shards=n_shards,
                                          overhead=overhead, bm=bm)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((rows, k_dim), generator=gen, device=dev)
    x = torch.randn((k_dim, n_dim), generator=gen, device=dev)
    out = coded_matmul.run(plan, a, x)
    y_ref = a @ x
    scale = float(y_ref.abs().max())
    sets = [np.arange(n_shards)] + [np.delete(np.arange(n_shards), s)
                                    for s in range(n_shards)]
    res = dict(survivors=[], max_abs_err=[], rel_err=[])
    for survivors in sets:
        y = coded_matmul.recover(plan, out, survivors)
        err = float((y - y_ref).abs().max())
        res["survivors"].append(survivors.tolist())
        res["max_abs_err"].append(err)
        res["rel_err"].append(err / scale)
        print(f"  survivors={survivors.tolist()}  max|err|={err:.2e}  "
              f"rel={err / scale:.2e}")
    print()
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    ccp_vs_best(args.device)
    coded_offload(args.device)
