"""The readers of the port's spans (`portbench/metrics/*.caption.py` over
`portbench/spans.py`): each one's value on synthetic Chrome events, None
without its spans, and the two span counts in a tiny traced run of the
caption cell."""

import pytest

from portbench import harness, spans
from portbench.tests.runs import tiny_run
from portbench.trace import records_from_events

# portbench's tiny cell runs min_length 7 of max_length 8: all 7 steps, the
# first (BOS) and last (EOS) forced; the host waits on the stream are the
# loop's done tests, the certificates' tests and pow_f32's two host scalars
# a step (the 4.18 rule)
STEPS, FORCED = 7, 2
SYNCS = STEPS + (STEPS - FORCED) + 2 * STEPS
SPAN_METRICS = ("encode_ms.caption", "decode_cache_ms.caption", "decode_step_ms.caption",
                "select_idle_ms.caption", "host_syncs.caption", "cert_fallbacks.caption")


def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _synthetic_events(with_spans: bool) -> list:
    """Two batches in a 0-1000 us window. A batch: encode 0-100 (a 40-us
    kernel), decode_cache 100-150 (20 us), then two steps: model (10-us
    kernel) then select (a 5-us kernel, then 15 us idle), and three syncs;
    batch 1 has one fallback."""
    ev = [_event("portbench.window", "user_annotation", 0, 1000)]
    corr = [0]

    def kernel(launch_ts, start, dur, name="k"):
        corr[0] += 1
        ev.append(_event("cudaLaunchKernel", "cuda_runtime", launch_ts, 1, correlation=corr[0]))
        ev.append(_event(name, "kernel", start, dur, correlation=corr[0]))

    def span(name, ts, dur):
        if with_spans:
            ev.append(_event(name, "user_annotation", ts, dur))

    for b, t0 in enumerate((0, 500)):
        span("generate.encode", t0, 100)
        kernel(t0 + 1, t0 + 10, 40)
        span("generate.decode_cache", t0 + 100, 50)
        kernel(t0 + 101, t0 + 110, 20)
        span("generate.beam_search", t0 + 150, 300)
        for step in range(2):
            s = t0 + 160 + 100 * step
            span("beam_search.sync", s - 5, 2)
            span("beam_search.model", s, 30)
            kernel(s + 1, s + 5, 10)
            span("beam_search.select", s + 30, 30)
            kernel(s + 31, s + 35, 5)
            span("beam_search.sync", s + 50, 2)
            if b == 1 and step == 0:
                span("beam_search.fallback", s + 53, 5)
        span("beam_search.sync", t0 + 400, 2)
    return ev


def _read(metric, rec):
    return harness.metric_reader(metric).read(rec)


def test_readers_on_synthetic_events():
    rec = records_from_events(_synthetic_events(True), units=2)
    assert spans.intervals(rec, "beam_search.model")[:2] == [(160, 190), (260, 290)]
    assert _read("encode_ms.caption", rec) == pytest.approx(0.040)
    assert _read("decode_cache_ms.caption", rec) == pytest.approx(0.020)
    assert _read("decode_step_ms.caption", rec) == pytest.approx(0.010)
    # select 30 us a step, 5 of it busy: 25 us idle a step, two steps a batch
    assert _read("select_idle_ms.caption", rec) == pytest.approx(0.050)
    assert _read("host_syncs.caption", rec) == 5
    assert _read("cert_fallbacks.caption", rec) == 0.5
    bare = records_from_events(_synthetic_events(False), units=2)
    assert bare.device and all(_read(m, bare) is None for m in SPAN_METRICS)
    assert all(_read(m, None) is None for m in SPAN_METRICS)


def test_tiny_caption_cell_reports_span_counts():
    line = tiny_run("vacnic_full.caption_b256", trace=True, seconds=0.2)
    got = {m: line["metrics"][m]["value"] for m in ("host_syncs.caption",
                                                    "cert_fallbacks.caption")}
    assert got == {"host_syncs.caption": SYNCS, "cert_fallbacks.caption": 0}
    # the device metrics are silent on the CPU
    assert not any(m in line["metrics"] for m in SPAN_METRICS[:4])
