"""Training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --steps 4 --batch 8 --seq 1024 --n-micro 2 [--ckpt DIR --ckpt-every 2 [--resume]]

builds the model on the card (``--device``, default ``cuda``; raises without
one) with remat, the port's random init from ``--seed``, and trains it with
AdamW on the deterministic synthetic stream (``data.SyntheticLM``), logging
loss, gradient norm, learning rate, the step's time on the host's clock
around a synchronise, and tokens per second.  Step times feed a
``CCPScheduler`` as the reference's heartbeat telemetry does.
``--smoke --device cpu`` trains the smoke config on the CPU.

``--mesh D,M`` with D * M > 1 trains across D * M ``torch.distributed``
ranks, one process each, started by ``torchrun`` (``WORLD_SIZE`` must be
D * M; or by a caller that already initialised the process group)::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch phi4-mini-3.8b --mesh 2,2 [--coded-dp] ...

Each rank builds the same weights from ``--seed``.  ``--mesh D,1`` is data
parallel: each rank takes its shard of the same global batch and applies
the same averaged update.  With M > 1 the ranks form a ``(data, model)``
``DeviceMesh``: the weights are laid out by the reference's sharding rules
(DTensors, ``parallel.sharding``), each model group computes its data
rank's rows tensor parallel (K4 on each rank's heads), and AdamW keeps
ZeRO-1 moments (``runtime.train_loop.make_train_step(mesh=...)``).
``--coded-dp`` makes data rank w worker w of the coded step (R-of-(R+K)
gradient aggregation, R = D; whole weights on every rank, the model
axis's ranks computing their worker alike).  The data ranks' step times
feed the ``CCPScheduler`` as the reference's heartbeat telemetry does; only
rank 0 prints and writes checkpoints.  Without a process group,
``--coded-dp`` runs the D workers in turn on the one device.  ``--ckpt
DIR`` saves ``{"params", "opt"}`` every ``--ckpt-every`` steps in the
background (``checkpoint.AsyncCheckpointer``, the reference's format; a
sharded state is gathered whole, every rank joining); ``--resume``
restores the latest step there into the model's tensors (each rank its
shards) and continues the loop from it.  Ranks that share one card take
gloo (``mesh.backend_for``).  ``--devices``, the reference's XLA flag that
forces host devices for its mesh, is ignored with a note: the port's mesh
is ranks, ``torchrun --nproc-per-node D*M``.
``REPRO_TRAIN_OVERRIDES`` (``key=int,...``) overrides config fields, as in
the reference.
"""

import argparse
import os
import sys
import time


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1,1", help="data,model axis sizes")
    ap.add_argument("--devices", type=int, default=0,
                    help="the reference's forced XLA host devices: ignored (the port's "
                         "data axis is torchrun's ranks)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--coded-dp", action="store_true",
                    help="use the coded-DP (R-of-R+K) training step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def run(argv=None, group=None) -> dict:
    """Train as ``main`` does; returns the final loss, the per-step
    history of the steps run (loss, grad_norm, lr, step ms, tokens/s and,
    of the first, each gradient leaf's sum of squares), the config, the
    device, the step the run started from, and with ``--ckpt`` the
    checkpoint's seconds (``restore_s`` of a resume; ``snapshot_s``, the
    loop's wait for the host copy, and ``write_s``, the background write,
    of the last save).  ``group``: the group of ``--mesh D,M``'s D * M
    ranks (default: the process group's world, started from ``torchrun``'s
    environment if need be); with M > 1 a group short of the world needs
    the world's other ranks to join ``launch.mesh.make_device_mesh(D, M,
    its ranks)`` meanwhile (a ``DeviceMesh`` is made by the whole world)."""
    args = _parse_args(argv)
    data_n, model_n = (int(x) for x in args.mesh.split(","))
    n_ranks = data_n * model_n
    if args.devices:
        print(f"note: --devices {args.devices} forces XLA host devices in the reference; "
              "the port ignores it: --mesh D,M runs across D*M ranks (torchrun "
              "--nproc-per-node D*M)", file=sys.stderr)

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import _device
    from repro_torch import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import CCPScheduler
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor as tp
    from repro_torch.runtime.train_loop import make_coded_train_step, make_train_step

    rank, dmesh = 0, None
    if group is None and n_ranks > 1 and (dist.is_initialized()
                                          or int(os.environ.get("WORLD_SIZE", 1)) > 1):
        group = dist.group.WORLD if dist.is_initialized() else mesh.init_ranks(device=args.device)
    if group is not None:
        rank = dist.get_rank(group)
        if dist.get_world_size(group) != n_ranks:
            raise ValueError(f"--mesh {args.mesh} needs {n_ranks} ranks, the group has "
                             f"{dist.get_world_size(group)}")
        dev = mesh.rank_device(args.device, dist.get_rank())
        if model_n > 1:
            dmesh = mesh.make_device_mesh(data_n, model_n,
                                          dist.get_process_group_ranks(group))
            group = dmesh.get_group("data")  # the workers and their heartbeats
    elif n_ranks > 1 and not (args.coded_dp and model_n == 1):
        raise ValueError(f"--mesh {args.mesh} trains across {n_ranks} ranks: start it under "
                         f"torchrun --nproc-per-node {n_ranks} (or, with --mesh D,1, add "
                         "--coded-dp to run the workers in turn on one device)")
    else:
        dev = _device.resolve(args.device)
    data_rank = rank if dmesh is None else dmesh.get_coordinate()[0]
    _device.full_fp32_matmuls(dev)
    say = print if rank == 0 else (lambda *a, **k: None)
    overrides = {}
    for kv in filter(None, os.environ.get("REPRO_TRAIN_OVERRIDES", "").split(",")):
        k, v = kv.split("=")
        overrides[k] = int(v)
    cfg = get_config(args.arch, smoke=args.smoke, **overrides)
    model = build_model(cfg, remat=True)
    tensor_parallel = dmesh is not None and not args.coded_dp
    params, axes = model.init(args.seed, device=dev, with_axes=True)
    if tensor_parallel:
        rules = sharding.make_rules(cfg, dmesh)
        params = tp.place_tree(params, sharding.param_shardings(dmesh, axes, rules))
        opt_state = adamw.init(params, sharding.opt_state_shardings(dmesh, axes, rules, params))
    else:
        opt_state = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                                total_steps=args.steps)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, n_micro=args.n_micro, seed=args.seed)
    start, ckpt, ckpt_times = 0, None, {}
    if args.ckpt:
        # a sharded state is gathered on every rank: each joins the save
        ckpt = ck.AsyncCheckpointer(args.ckpt) if rank == 0 or tensor_parallel else None
        if args.resume and ck.latest_step(args.ckpt) is not None:
            t0 = time.perf_counter()
            state, meta = ck.restore(args.ckpt, None, {"params": params, "opt": opt_state})
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ckpt_times["restore_s"] = time.perf_counter() - t0
            params, opt_state = state["params"], state["opt"]
            start = int(meta.get("step", 0))
            say(f"resumed from step {start}", flush=True)

    sched = CCPScheduler(n_workers=data_n)
    if args.coded_dp:
        step_fn, code, (pats, ws) = make_coded_train_step(
            model, opt_cfg, data_n, seed=args.seed, device=dev,
            group=None if dmesh else group, mesh=dmesh)
        w0 = ws[0]

        def run_step(params, opt_state, batch):
            # batch (n_micro, mb, T) -> the coded step's (R, mb', T)
            tok = batch["tokens"].reshape(data_n, -1, batch["tokens"].shape[-1])
            lab = batch["labels"].reshape(data_n, -1, batch["labels"].shape[-1])
            return step_fn(params, opt_state, {"tokens": tok, "labels": lab}, w0)
    else:
        run_step = make_train_step(model, opt_cfg, args.n_micro, pre_shaped=True, device=dev,
                                   group=None if dmesh else group, mesh=dmesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history, loss = [], float("nan")
    t_start = time.perf_counter()
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in data.batch(step).items()}
        sync()
        t0 = time.perf_counter()
        params, opt_state, metrics = run_step(params, opt_state, batch)
        sync()
        dt = time.perf_counter() - t0
        loss = float(metrics["loss"])
        if group is None:
            sched.observe_step(np.full(data_n, dt))
        else:  # every data rank's own step time: the workers' heartbeats
            times = torch.zeros(data_n, dtype=torch.float64, device=dev)
            times[data_rank] = dt
            dist.all_reduce(times, op=dist.ReduceOp.MAX, group=group)
            sched.observe_step(times.cpu().numpy())
        rec = dict(step=step, loss=loss, grad_norm=float(metrics["grad_norm"]),
                   lr=float(metrics["lr"]), ms=dt * 1e3,
                   tokens_per_s=args.batch * args.seq / dt)
        if step == start:
            rec["grad_leaf_sq"] = metrics["grad_leaf_sq"].cpu().numpy()
        history.append(rec)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} gnorm {rec['grad_norm']:.3f} "
                f"lr {rec['lr']:.2e} {dt * 1e3:.0f}ms {rec['tokens_per_s']:.0f} tok/s",
                flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, {"params": params, "opt": opt_state},
                            metadata={"step": step + 1})
    if ckpt:
        ckpt.wait()
        ckpt_times.update(snapshot_s=ckpt.snapshot_s, write_s=ckpt.write_s)
    wall = time.perf_counter() - t_start
    say(f"done: {args.steps - start} steps in {wall:.1f}s on {dev}"
        + (f" x {n_ranks} ranks" if group is not None else "") + f", final loss {loss:.4f}")
    return dict(loss=loss, history=history, cfg=cfg, device=dev, wall_s=wall,
                sched_e_beta=sched.e_beta, start=start, ckpt=ckpt_times, rank=rank,
                ranks=1 if group is None else n_ranks)


def rank_main(rank: int, world_size: int, store_path: str, argv) -> dict:
    """``run(argv)`` as rank ``rank`` of ``world_size`` ranks that
    ``launch.mesh.spawn_ranks`` started (a FileStore rendezvous at
    ``store_path``, the device of ``argv``'s ``--device``); returns the
    losses, the rank's count of ranks, and the top-level packages of the
    modules the rank imported."""
    from repro_torch.launch import mesh

    mesh.init_ranks(rank, world_size, device=_parse_args(argv).device, store_path=store_path)
    res = run(argv)
    import torch.distributed as dist

    dist.destroy_process_group()
    return dict(losses=[h["loss"] for h in res["history"]], ranks=res["ranks"],
                modules=sorted({m.split(".")[0] for m in sys.modules}))


def main(argv=None):
    return run(argv)["loss"]


if __name__ == "__main__":
    main()
