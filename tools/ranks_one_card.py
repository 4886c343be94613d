"""Which backend takes ranks that share one card, and at what rate.

    python3 tools/ranks_one_card.py

On a machine with one CUDA card: (1) two ranks on card 0 with NCCL, which
is expected to refuse them ("Duplicate GPU detected"); (2) four ranks on
card 0 with gloo: an all-reduce SUM and MAX of CUDA tensors checked
against the expected values, then the host-clock time of an all-reduce SUM
of 0.25, 1 and 3.26 GB of float32 (the last is phi4-mini's gradient at 2
layers) with the rate it implies.  Prints one line per result and the
card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SIZES_GB = (0.25, 1.0, 3.2637)


def nccl_rank(rank: int, world: int, store: str) -> str:
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh

    mesh.init_ranks(rank, world, device="cuda:0", store_path=store, backend="nccl",
                    timeout_s=60)
    t = torch.ones(4, device="cuda:0")
    try:
        dist.all_reduce(t)
        torch.cuda.synchronize()
        result = f"all_reduce ran: {t.tolist()}"
    except Exception as e:  # the probe reports what NCCL says
        result = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return result


def gloo_rank(rank: int, world: int, store: str) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh

    group = mesh.init_ranks(rank, world, device="cuda:0", store_path=store, timeout_s=300)
    out = {"backend": dist.get_backend(group)}
    t = torch.full((1000,), float(rank + 1), device="cuda:0")
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    m = torch.full((1000,), float(rank + 1), device="cuda:0")
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    torch.cuda.synchronize()
    out["sum_ok"] = bool((t == world * (world + 1) / 2).all())
    out["max_ok"] = bool((m == world).all())
    out["times"] = {}
    for gb in SIZES_GB:
        x = torch.ones(int(gb * 1e9 / 4), device="cuda:0")
        for _ in range(2):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize()
            out["times"].setdefault(gb, []).append(time.perf_counter() - t0)
        del x
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return out


def main() -> int:
    import torch
    from repro_torch.launch import mesh

    if not torch.cuda.is_available():
        print("ranks_one_card: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    try:
        for r, res in enumerate(mesh.spawn_ranks(nccl_rank, 2, timeout_s=180)):
            print(f"[nccl-one-card] rank={r} result={res!r}", flush=True)
    except Exception as e:  # a rank that died or hung is the probe's answer too
        print(f"[nccl-one-card] ranks failed: {type(e).__name__}: "
              f"{str(e).strip().splitlines()[-1][:300]}", flush=True)
    ranks = mesh.spawn_ranks(gloo_rank, 4, timeout_s=600)
    for r, res in enumerate(ranks):
        times = " ".join(f"{gb}GB={','.join(f'{s:.3f}' for s in ts)}s"
                         for gb, ts in res["times"].items())
        print(f"[gloo-one-card] rank={r} backend={res['backend']} sum_ok={res['sum_ok']} "
              f"max_ok={res['max_ok']} {times}", flush=True)
    for gb, ts in ranks[0]["times"].items():
        print(f"[gloo-one-card] size_gb={gb} best_s={min(ts):.3f} "
              f"rate_gbps={gb / min(ts):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
