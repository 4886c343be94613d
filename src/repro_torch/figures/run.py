"""Run the paper-figure scripts and print ``name,-,derived`` CSV rows.

  fig3        delay vs rows, Scenarios 1/2 (paper Fig. 3)
  fig4        delay vs rows, mu in {1,3,9} (paper Fig. 4)
  fig5        CCP vs best/naive gaps on slow links (paper Fig. 5)
  efficiency  measured vs eq. (12) efficiency (paper §6 table)
  fig_churn   delay under churn: i.i.d., burst and cell-outage sweeps
  fig_decode  measured LT decode overhead vs i.i.d. loss
  fig_transport  delay vs feedback RTT: iid, burst and cell regimes
  fig_fleet   tenant sojourn vs offered load on a shared pool

Everything, on the card:  PYTHONPATH=src python -m repro_torch.figures.run
Subset:                   PYTHONPATH=src python -m repro_torch.figures.run --only fig3,fig5
Smoke, on the CPU:        PYTHONPATH=src python -m repro_torch.figures.run --smoke --device cpu
Policy subset:            PYTHONPATH=src python -m repro_torch.figures.run --only fig3 \\
                              --policies ccp,hcmm

Each figure writes ``<out>/<name>.json`` (default ``build/repro_torch/figures/``).
"""

from __future__ import annotations

import argparse

from ..core import policies as policy_registry
from . import efficiency, fig3, fig4, fig5, fig_churn, fig_decode, fig_fleet, fig_transport


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, help="comma-separated subset of figure names")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweeps (2 reps, one or two R per figure)")
    ap.add_argument("--reps", type=int, default=None,
                    help="Monte-Carlo reps per point for every figure")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", default=None, help="output directory of the JSON files")
    ap.add_argument("--policies", default=None,
                    help="comma-separated registered policies for fig3/fig4/fig5/fig_churn/"
                         "fig_transport/fig_fleet")
    args = ap.parse_args(argv)

    common = dict(device=args.device, out_dir=args.out)
    if args.policies is not None:
        swept = tuple(args.policies.split(","))
        for p in swept:
            policy_registry.get(p)  # fail loudly on typos, with the known names
        fig_kw = dict(common, policies=swept)
    else:
        fig_kw = common
    if args.smoke:
        reps = 2 if args.reps is None else args.reps
        jobs = {
            "fig3": lambda: fig3.run(reps=reps, r_sweep=(500,), **fig_kw),
            "fig4": lambda: fig4.run(reps=reps, r_sweep=(500,), **fig_kw),
            "fig5": lambda: fig5.run(reps=reps, r_sweep=(200, 400), **fig_kw),
            "efficiency": lambda: efficiency.run(reps=reps, R=400, **common),
            # Each sweep's end points at a tenth of the figure's width.
            "fig_churn": lambda: fig_churn.run(
                reps=reps, R=100, n_helpers=10, **fig_kw,
                sweeps={k: ((ax[0], ax[-1]), mk, name)
                        for k, (ax, mk, name) in fig_churn.SWEEPS.items()}),
            "fig_decode": lambda: fig_decode.run(reps=reps, sweep=(0.0, 0.2), R=100,
                                                 n_helpers=10, offline_trials=2, **common),
            "fig_transport": lambda: fig_transport.run(
                reps=reps, R=100, n_helpers=10, rtt_sweep=(0.0, 4.0), **fig_kw),
            "fig_fleet": lambda: fig_fleet.run(
                reps=reps, task_sweep=(1, 4), R=100, n_helpers=10, **fig_kw),
        }
    else:
        reps = {} if args.reps is None else dict(reps=args.reps)
        jobs = {
            "fig3": lambda: fig3.run(**reps, **fig_kw),
            "fig4": lambda: fig4.run(**reps, **fig_kw),
            "fig5": lambda: fig5.run(**reps, **fig_kw),
            "efficiency": lambda: efficiency.run(**reps, **common),
            "fig_churn": lambda: fig_churn.run(**reps, **fig_kw),
            "fig_decode": lambda: fig_decode.run(**reps, **common),
            "fig_transport": lambda: fig_transport.run(**reps, **fig_kw),
            "fig_fleet": lambda: fig_fleet.run(**reps, **fig_kw),
        }
    only = args.only.split(",") if args.only else list(jobs)
    unknown = set(only) - set(jobs)
    if unknown:
        raise SystemExit(f"unknown figures {sorted(unknown)}; known: {list(jobs)}")
    print("name,-,derived")
    return {name: jobs[name]() for name in jobs if name in only}


if __name__ == "__main__":
    main()
