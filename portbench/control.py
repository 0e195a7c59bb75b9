"""The readings that set a cell's limits and rate, not part of any benchmark run:

    python3 -m portbench.control --workload <cell> --seeds 12 --control-seeds 3 [--batches 2]
    python3 -m portbench.control --workload <serving cell> --sweep 140,170,200 [--sweep-seconds 20] [--sweep-repeats 3]

For each seed, in one process, the cell's driver's `control`: its set-up,
the timed path at the cell's own size (`--batches` batches of a captioning
cell, a training cell's first three steps), and the check's numbers (the
lower readings); for the first `--control-seeds` seeds also the control's
(the plain reference on float8 e4m3 operands, one scale a tensor, put in
the program's place) and the planted faults' (the upper readings). Prints
one JSON line a seed and a summary a number. `--sweep` runs a serving
cell's load at each rate instead, for its knee: several windows a rate,
each read by the rate answered and the backlog's slope over its last two
thirds."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--sweep", default="",
                    help="comma-separated request rates: the knee's sweep of a serving cell")
    ap.add_argument("--sweep-seconds", type=float, default=20.0)
    ap.add_argument("--sweep-repeats", type=int, default=3)
    args = ap.parse_args(argv)

    from portbench import harness

    bench = harness.load_manifest(os.getcwd())
    cell = harness.find_cell(bench, args.workload)
    harness.require_cards(cell["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec, config = harness.cell_spec(cell["name"]), harness.config_file(cell["config"])
    driver = harness.driver_module(spec["driver"])
    if args.sweep:
        ctx = harness.Context(name=cell["name"], spec=spec, config=config, seed=args.first_seed,
                              seconds=args.sweep_seconds, trace=False, device="cuda",
                              t_start=time.perf_counter())
        out = driver.sweep(ctx, [float(r) for r in args.sweep.split(",")], args.sweep_seconds,
                           args.sweep_repeats)
        print(json.dumps({"sweep": cell["name"], "rows": out}), flush=True)
        return 0
    rows = []
    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        ctx = harness.Context(name=cell["name"], spec=spec, config=config, seed=seed,
                              seconds=0.0, trace=False, device="cuda",
                              t_start=time.perf_counter())
        row = driver.control(ctx, args.batches, with_control=j < args.control_seeds)
        row["seed"] = seed
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    for name in rows[0]["program"]:
        summary = {"summary": cell["name"], "number": name,
                   "lower_reading": max(r["program"][name] for r in rows)}
        for group in sorted({g for r in rows for g in r} - {"program", "seed", "leaves"}):
            vals = [r[group][name] for r in rows if group in r]
            summary[f"{group}_least"] = min(vals)
            summary[group] = vals
        summary["program"] = [r["program"][name] for r in rows]
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
