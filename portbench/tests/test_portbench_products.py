"""`bf16_products_pct.train` (portbench/metrics/bf16_products_pct.train.py)
on synthetic Chrome events: the port's "product.bf16" spans over all its
"product.*" spans, and silent without them (an older port)."""

import pytest

from portbench import harness
from portbench.trace import records_from_events

METRIC = "bf16_products_pct.train"


def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _synthetic_events(with_spans: bool) -> list:
    """Two steps in a 0-1000 us window. A step: the forward (three bf16
    products, one kernel each), then the backward (two bf16 products a
    forward product, and one float32 product pair for the last: the
    scores' or the LM head's), and the optimizer's kernel outside any."""
    ev = [_event("portbench.window", "user_annotation", 0, 1000)]
    corr = [0]

    def kernel(ts, name="gemm"):
        corr[0] += 1
        ev.append(_event("cudaLaunchKernel", "cuda_runtime", ts, 1, correlation=corr[0]))
        ev.append(_event(name, "kernel", ts + 2, 5, correlation=corr[0]))

    def product(name, ts):
        if with_spans:
            ev.append(_event(name, "user_annotation", ts, 4))
        kernel(ts + 1)

    for t0 in (0, 500):
        ev.append(_event("train_step.forward", "user_annotation", t0, 100))
        for i in range(3):
            product("product.bf16", t0 + 10 + 20 * i)
        ev.append(_event("train_step.backward", "user_annotation", t0 + 100, 300))
        for i in range(4):
            product("product.bf16", t0 + 110 + 20 * i)
        for i in range(2):
            product("product.f32", t0 + 200 + 20 * i)
        kernel(t0 + 420, "multi_tensor_apply_kernel")
    return ev


def _read(rec):
    return harness.metric_reader(METRIC).read(rec)


def test_bf16_products_pct_on_synthetic_events():
    rec = records_from_events(_synthetic_events(True), units=2)
    # 7 bf16 and 2 float32 products a step
    assert _read(rec) == pytest.approx(100.0 * 7 / 9)
    bare = records_from_events(_synthetic_events(False), units=2)
    assert bare.device and _read(bare) is None
    assert _read(None) is None


def test_bf16_products_pct_is_declared_for_the_train_cell():
    bench = harness.load_manifest(harness.os.path.dirname(harness.HERE))
    metric = {m["name"]: m for m in bench["per_layer"]}[METRIC]
    assert metric["workloads"] == ["vacnic_full.train_b32"]
    assert metric["moves"] == "train_samples_per_s" and metric["source"] == "program_span"
    names = [m["name"] for m in harness.per_layer_for(bench, "vacnic_full.train_b32")]
    assert METRIC in names
    assert METRIC not in [m["name"] for m in harness.per_layer_for(bench,
                                                                  "vacnic_full.caption_b256")]
