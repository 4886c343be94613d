"""Checks the dry run's extrapolated peak memory against a direct count.

For each train_4k cell, rank 0's step at full depth and two microbatches
(the probes' largest M) is counted directly on meta tensors
(``launch.dryrun.count_step``), and its peak live bytes are printed beside
those that ``launch.dryrun.probe_cell`` extrapolates from its 1- and
2-group probes.  xLSTM's cells are left out: a full-length step of its
loops over time is millions of dispatches.  Needs no card:

    PYTHONPATH=src python tools/dryrun_full_depth.py [--arch A] [--mesh single|multi]
"""

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.parallel import sharding as shd


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    args = ap.parse_args()
    torch.set_num_threads(1)
    shape = SHAPES["train_4k"]
    for arch in [args.arch] if args.arch else ARCH_IDS:
        cfg = dryrun.cell_config(arch)
        if dryrun._time_scanned(cfg):
            continue
        for name in [args.mesh] if args.mesh else ["single", "multi"]:
            mesh = dryrun.production_mesh(name == "multi")
            rules = shd.make_rules(cfg, mesh)
            n_micro = dryrun.cell_n_micro(arch, shape, mesh)
            t0 = time.perf_counter()
            probe = dryrun.probe_cell(cfg, shape, n_micro, mesh, rules)["totals"]
            two = dataclasses.replace(shape, global_batch=shape.global_batch // n_micro * 2)
            direct = dryrun.count_step(cfg, two, 2, mesh, rules)
            print(json.dumps({"arch": arch, "mesh": name,
                              "peak_extrapolated": probe["peak_bytes"],
                              "peak_direct_m2": direct["peak_bytes"],
                              "ratio": probe["peak_bytes"] / direct["peak_bytes"],
                              "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
