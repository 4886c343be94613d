"""What DTensor and gloo take from ranks that share one card.

    python3 tools/dtensor_one_card.py

Four ranks on card 0 with gloo (``launch.mesh.init_ranks``): a (2, 2)
``DeviceMesh`` named (data, model) over them, a (1, 2) mesh over ranks 0-1
that every rank takes part in creating, then each collective that a
tensor-parallel step may ask of gloo on CUDA tensors (``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_to_all_single``,
``broadcast``, ``all_reduce`` MAX), DTensor's ``from_local`` / ``to_local``
with a gradient through them, and ``full_tensor``.  Prints one line a
check (``ok`` or the exception's first line), torch's version and the
card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _try(out: dict, name: str, fn) -> None:
    try:
        res = fn()
        out[name] = "ok" if res is None or res is True else f"WRONG {res}"
    except Exception as e:  # the probe reports what the backend says
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


SAFE = ("all_reduce_max", "broadcast", "all_gather", "submesh_all_reduce",
        "dtensor_to_local_grad")
RISKY = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single", "full_tensor")


def probe_rank(rank: int, world: int, store: str, names) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import mesh

    mesh.init_ranks(rank, world, device="cuda:0", store_path=store, timeout_s=120)
    dev = torch.device("cuda:0")
    out: dict = {}
    say = (lambda m: print(f"[probe] {m}", flush=True)) if rank == 0 else (lambda m: None)
    say("init")
    dm = DeviceMesh("cuda", torch.arange(world).reshape(2, 2), mesh_dim_names=("data", "model"))
    say("mesh")
    sub = DeviceMesh("cuda", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))
    say("submesh")
    out["coord"] = (dm.get_coordinate(), sub.get_coordinate())
    g = dm.get_group("model")

    def gather_list():
        parts = [torch.empty(3, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((3,), float(rank), device=dev), group=g)
        return bool(torch.cat(parts).sum() == 3 * sum(dist.get_process_group_ranks(g)))

    def gather_into():
        o = torch.empty(6, device=dev)
        dist.all_gather_into_tensor(o, torch.full((3,), float(rank), device=dev), group=g)
        return bool(o.sum() == 3 * sum(dist.get_process_group_ranks(g)))

    def reduce_scatter():
        o = torch.empty(3, device=dev)
        dist.reduce_scatter_tensor(o, torch.ones(6, device=dev), group=g)
        return bool((o == 2).all())

    def a2a():
        o = torch.empty(4, device=dev)
        dist.all_to_all_single(o, torch.full((4,), float(rank), device=dev), group=g)
        r0, r1 = dist.get_process_group_ranks(g)
        return o.tolist() == [float(r0)] * 2 + [float(r1)] * 2

    def bcast():
        x = torch.full((3,), float(rank), device=dev)
        dist.broadcast(x, src=dist.get_process_group_ranks(g)[0], group=g)
        return bool((x == dist.get_process_group_ranks(g)[0]).all())

    def amax():
        x = torch.full((3,), float(rank), device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
        return bool((x == max(dist.get_process_group_ranks(g))).all())

    def dtensor_grad():
        w = torch.randn(4, 3, device=dev, requires_grad=True)
        t = DTensor.from_local(w, dm, [Replicate(), Shard(0)], run_check=False)
        loc = t.to_local()
        (loc * 2).sum().backward()
        return bool((w.grad == 2).all())

    def full():
        t = DTensor.from_local(torch.full((2, 3), float(rank), device=dev), dm,
                               [Shard(0), Shard(1)], run_check=False)
        return tuple(t.full_tensor().shape) == (4, 6)

    def sub_reduce():
        if sub.get_coordinate() is None:
            return None
        x = torch.ones(2, device=dev)
        dist.all_reduce(x, group=sub.get_group("model"))
        return bool((x == 2).all())

    checks = {"all_gather": gather_list, "all_gather_into_tensor": gather_into,
              "reduce_scatter_tensor": reduce_scatter, "all_to_all_single": a2a,
              "broadcast": bcast, "all_reduce_max": amax, "dtensor_to_local_grad": dtensor_grad,
              "full_tensor": full, "submesh_all_reduce": sub_reduce}
    for name in names:
        say(f"{name} ...")
        _try(out, name, checks[name])
        say(f"{name}: {out[name]}")
        torch.cuda.synchronize()
        dist.barrier()
    dist.destroy_process_group()
    return out


def main() -> int:
    import torch
    from repro_torch.launch import mesh

    if not torch.cuda.is_available():
        print("dtensor_one_card: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[card] {smi.stdout.strip()} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    # The safe checks in one set of ranks, then each that may crash a rank
    # (a segfault ends the set) in a set of its own.
    for names in (SAFE,) + tuple((n,) for n in RISKY):
        try:
            outs = mesh.spawn_ranks(probe_rank, 4, names, timeout_s=120)
        except Exception as e:
            print(f"[set] {names}: {type(e).__name__}: {str(e).splitlines()[-1][:200]}",
                  flush=True)
            continue
        for r, out in enumerate(outs):
            for k, v in out.items():
                print(f"[rank{r}] {k}: {v}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
