"""Each cell's driver at the tiny configuration on the CPU: the result line
has the contract's keys with the checks last, the metrics the manifest asks
of the cell, and `correct` true; without a card the command prints no
result and exits 2."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.runs import CELLS, ROOT, tiny_run

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_the_contract_line(cell, trace, capsys):
    bench = harness.load_manifest(ROOT)
    line = tiny_run(cell, trace)
    harness.emit(line)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    extra = {"breakdown"} if trace else set()
    assert set(last) == CONTRACT | extra | {"checks"} and list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    assert out.err.strip().splitlines()[-1].startswith("check ")
    if not trace:
        want = {m["name"] for m in harness.end_to_end_for(bench, cell)}
        assert set(last["metrics"]) == want and "breakdown" not in last
    else:
        allowed = {m["name"] for m in harness.per_layer_for(bench, cell)}
        assert set(last["metrics"]) <= allowed
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device on the CPU: every device_trace metric is silent, never 0
        traced = {m["name"] for m in bench["per_layer"] if m["source"] == "device_trace"}
        assert not set(last["metrics"]) & traced
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items()}
    env["PYTHONPATH"] = cwd
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run(["--workload", CELLS[0], "--seed", str(2 ** 31 + 3), "--seconds", "1",
                "--trace", "0"], ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(["--workload", CELLS[0], "--seed", "5", "--seconds", "1", "--trace", "0"],
               str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_cell_no_result():
    out = _run(["--workload", "no_such.cell", "--seed", "5", "--seconds", "1", "--trace", "0"],
               ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_backlog_slope_reads_growth_and_none():
    import numpy as np

    from portbench.drivers.serve_open import backlog_slope

    due = np.arange(0.0, 30.0, 0.01)  # 100 requests/s
    assert abs(backlog_slope(due, due + 1.0, 10.0, 30.0)) < 1e-6
    half = np.where(np.arange(len(due)) % 2 == 0, due + 1.0, np.nan)  # half never answered
    assert backlog_slope(due, half, 10.0, 30.0) == pytest.approx(50.0, rel=0.02)


def test_train_readings_name_their_leaves():
    """The check's numbers and the worst leaves' paths on a tiny control
    row: a path for each bart leaf, the median gaps beside the worst."""
    from portbench.drivers import train_closed
    from portbench.tests.runs import tiny_context

    ctx = tiny_context(CELLS[2])
    names = train_closed.leaf_names(ctx.sizes)
    assert len(names) == len(set(names)) > 100
    row = train_closed.control(ctx, 0, with_control=False)
    p = row["program"]
    assert p["grad_median_gap"] <= p["grad_norm_gap"] and p["change_median_gap"] <= p["change_norm_gap"]
    worst = row["leaves"]["program"]["grad_norms"]
    assert worst[0][0] in names and worst[0][1] == pytest.approx(p["grad_norm_gap"])
