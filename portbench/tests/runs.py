"""Tiny runs of the cells on the CPU for the tests: the real manifest and
cell files with the tiny configuration, smaller batches and windows, and
limits scaled to what the tiny model reads (a sound tiny run reads about a
tenth of these on the CPU, where the port and the reference agree to f32
rounding)."""

import os
import time

from portbench import harness
from portbench.tests.tiny import tiny_config, tiny_spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("vacnic_full.caption_b256", "vacnic_onlyvis.caption_b256", "vacnic_full.train_b32",
         "vacnic_full.serve_open")
TINY_LIMITS = {"caption_closed": {"score_gap_nats": 0.02},
               "serve_open": {"score_gap_nats": 0.02},
               "train_closed": {"loss_gap": 1e-4, "grad_norm_gap": 1e-3, "change_norm_gap": 1e-3,
                                "change_median_gap": 1e-3}}
SEED = 2 ** 31 + 11


def tiny_cell(cell: str):
    bench = harness.load_manifest(ROOT)
    c = harness.find_cell(bench, cell)
    spec = tiny_spec(harness.cell_spec(cell))
    spec["limits"] = TINY_LIMITS[spec["driver"]]
    if spec["driver"] == "serve_open":
        # arrivals faster than a tiny decode, so batches hold several rows
        spec.update(rate_rps=100.0, drain_s=30.0, trace_seconds=0.5)
    if spec["driver"] in ("caption_closed", "serve_open"):
        spec["check_rows"] = 12
    config = tiny_config(harness.config_file(c["config"])["sizes"]["only_image"])
    return bench, c, spec, config


def tiny_run(cell: str, trace: bool = False, seconds: float = 1.0, seed: int = SEED) -> dict:
    bench, c, spec, config = tiny_cell(cell)
    return harness.execute(bench, c, seed=seed, seconds=seconds, trace=trace, device="cpu",
                           t_start=time.perf_counter(), spec=spec, config=config)


def tiny_context(cell: str, seed: int = SEED, seconds: float = 0.0) -> harness.Context:
    _, c, spec, config = tiny_cell(cell)
    return harness.Context(name=c["name"], spec=spec, config=config, seed=seed, seconds=seconds,
                           trace=False, device="cpu", t_start=time.perf_counter())
