"""One run of one benchmark cell:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The cell's entry
there names its configuration; `portbench/workloads/<cell>.json` names its
driver (`portbench/drivers/<driver>.py`) and holds its traffic;
`portbench/configs/<config>.json` holds the configuration; each per-layer
metric is read by `portbench/metrics/<metric>.py`. Nothing here names a cell.

The run makes its weights and inputs from --seed, warms up the cell's
shapes (set-up), measures for --seconds, checks what the timed path
produced against the plain reference (portbench/reference), and prints one
JSON line last on standard output: correct, attempted, failed, metrics
(the end-to-end ones with --trace 0, the per-layer ones with --trace 1),
device, breakdown (--trace 1) and checks (each number compared, with its
limit), the checks again as the last lines of standard error.

It exits with 2 and prints no result where there is no CUDA device or
fewer than the cell asks for, where the port is missing from the
checkout, or where JAX or the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "vacnic_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    try:
        bench = harness.load_manifest(os.getcwd())
        cell = harness.find_cell(bench, args.workload)
        harness.require_cards(cell["chips"])
        line = harness.execute(bench, cell, seed=args.seed, seconds=args.seconds,
                               trace=bool(args.trace), device="cuda", t_start=T_START)
    except harness.Refused as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: no result: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 2
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
