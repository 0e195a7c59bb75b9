"""The port's spans (`core/profiling.annotate`) on the CPU, read from the
Chrome trace that the port's own exporter, `core/profiling.trace`, writes:

* without a profiler, `annotate` never reaches `record_function`;
* `trace` records the spans of every thread, not only the caller's;
* `generate_mm` emits "generate.encode", ".decode_cache", ".beam_search" in
  that order, and inside the search one "beam_search.model" and one
  ".select" a step and one ".sync" a wait of the host on the stream; its
  tokens and scores are bit-identical with the profiler on and off;
* a certificate that fails emits one "beam_search.fallback" a fallback step
  (the opt window and the shortlist, shrunk), holding the one ".sync" of
  its n-gram bans;
* a CPU `CaptionService` emits one "serve.batch" a dispatched batch, each
  holding one "serve.stage", ".decode" and ".respond", and stacks its rows
  outside the device lock.

The benchmark's readers of these spans are tested beside them, in
`portbench/tests/test_portbench_spans.py`."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vacnic_tpu_torch.core import profiling
from vacnic_tpu_torch.core.config import DecodeConfig, VacnicConfig
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.data.synthetic import synthetic_batch
from vacnic_tpu_torch.infer import beam_search as BS
from vacnic_tpu_torch.infer.generate import generate_mm
from vacnic_tpu_torch.models.fusion import multimodal_bart_init
from vacnic_tpu_torch.serve import CaptionService, ServeConfig
from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

# the tiny config with min_length 7 of max_length 8: every item runs all 7
# steps, the first (BOS) and last (EOS) forced
STEPS, FORCED = 7, 2
CERTS = STEPS - FORCED  # the shortlist certificates' tests
POWS = 2 * STEPS  # pow_f32's host scalars: the finished and (4.18) the final scores
SYNCS = STEPS + CERTS + POWS  # with the loop's done tests


@pytest.fixture(scope="module")
def tiny():
    cfg = VacnicConfig.tiny()
    cfg = dataclasses.replace(cfg, decode=dataclasses.replace(cfg.decode, min_length=STEPS))
    params = multimodal_bart_init(make_generator(0), cfg.bart, cfg.fusion)
    b = synthetic_batch(cfg, 2, seed=3)
    x = dict(input_ids=b["article_ids"], attention_mask=create_mask(b["article_ids"]),
             image_features=b["image_cls"], face_features=b["face_emb"],
             face_mask=face_mask_from_emb(b["face_emb"]), name_ids=b["names_art_ids"],
             name_mask=create_mask(b["names_art_ids"]))

    def generate():
        return generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                           device="cpu", **x)

    return cfg, params, generate


def _traced(fn, log_dir) -> dict:
    """{span name: sorted (start_us, end_us)} of the ranges in the Chrome
    trace that `profiling.trace(log_dir)` writes around `fn()`."""
    with profiling.trace(str(log_dir)):
        fn()
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    spans: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return {n: sorted(v) for n, v in spans.items()}


def _inside(inner, outer):
    return all(any(o0 <= i0 and i1 <= o1 for o0, o1 in outer) for i0, i1 in inner)


def _within(outer, inner):
    """How many of `inner` lie inside the span `outer`."""
    return sum(outer[0] <= i0 and i1 <= outer[1] for i0, i1 in inner)


def test_annotate_without_profiler_makes_no_record_function(monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: calls.append(name) or real(name, *a))
    for _ in range(3):
        with profiling.annotate("span.off"):
            pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("span.on"):
            pass
    assert calls == ["span.on"]


def test_trace_records_every_thread(tmp_path):
    def other():
        with profiling.annotate("span.other_thread"):
            torch.ones(8).sum()

    def run():
        with profiling.annotate("span.caller"):
            t = threading.Thread(target=other)
            t.start()
            t.join()

    spans = _traced(run, tmp_path)
    assert len(spans["span.caller"]) == len(spans["span.other_thread"]) == 1
    assert _inside(spans["span.other_thread"], spans["span.caller"])


def test_generate_mm_spans_nest_and_count(tiny, tmp_path):
    _, _, generate = tiny
    spans = _traced(generate, tmp_path)
    enc, cache, search = (spans[f"generate.{n}"] for n in ("encode", "decode_cache",
                                                            "beam_search"))
    assert len(enc) == len(cache) == len(search) == 1
    assert enc[0][1] <= cache[0][0] and cache[0][1] <= search[0][0]
    model, select, sync = (spans[f"beam_search.{n}"] for n in ("model", "select", "sync"))
    assert len(model) == len(select) == STEPS
    assert len(sync) == SYNCS
    assert _inside(model + select + sync, search)
    # each step's model span precedes its select span; the certificates'
    # reads and the host scalars sit inside select, the loop's done tests
    # outside both
    for (m0, m1), (s0, _) in zip(model, select):
        assert m1 <= s0
    assert sum(_inside([s], select) for s in sync) == CERTS + POWS
    assert not any(_inside([s], model) for s in sync)
    assert "beam_search.fallback" not in spans


def test_generate_mm_identical_with_profiler_on_and_off(tiny):
    _, _, generate = tiny
    off = generate()
    with profile(activities=[ProfilerActivity.CPU]):
        on = generate()
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mode", ["opt", "shortlist"])
def test_one_fallback_span_a_fallback_step(mode, monkeypatch, tmp_path):
    """A window of 2K + 1 (opt) or a shortlist of 2K + 1 tolerates one ban a
    row; rows that all favour the same dozen tokens pile their n-gram bans
    on the top candidates, so some steps fall back to the full selection
    (the only caller of candidates_full in these modes)."""
    k, vocab = 5, 256
    rng = np.random.RandomState(0)
    base = np.full(vocab, -30.0, np.float32)
    base[:12] = -0.3 * np.arange(12)
    table = torch.from_numpy((base[None] + 0.05 * rng.randn(64, vocab)).astype(np.float32))
    monkeypatch.setattr(BS, "OPT_WINDOW", 2 * k + 1)
    monkeypatch.setattr(BS, "shortlist_c_width", lambda kk: 2 * kk + 1)
    fallbacks = []
    real = BS.candidates_full
    monkeypatch.setattr(BS, "candidates_full",
                        lambda *a, **kw: fallbacks.append(1) or real(*a, **kw))
    cfg = DecodeConfig(num_beams=k, max_length=12, length_penalty=2.0, early_stopping=True,
                       no_repeat_ngram_size=3, forced_eos=True)

    def search():
        BS.beam_search(lambda tok, cache, pos: (table[tok[:, 0] % 64], cache), None, 3,
                       cfg=cfg, eos_token_id=2, pad_token_id=1, decoder_start_token_id=2,
                       forced_bos_token_id=0, vocab_size=vocab,
                       reorder_cache_fn=lambda c, sel: c, device="cpu", cand_mode=mode)

    spans = _traced(search, tmp_path)
    fb = spans.get("beam_search.fallback", [])
    assert fallbacks and len(fb) == len(fallbacks)
    assert _inside(fb, spans["beam_search.select"])
    # the n-gram bans' one read of the host
    assert all(_within(f, spans["beam_search.sync"]) == 1 for f in fb)


def _service(cfg, params, n):
    svc = CaptionService(cfg, {"model": params}, serve_cfg=ServeConfig(max_wait_ms=5.0),
                         device="cpu")
    batch = synthetic_batch(cfg, n, seed=1)
    rows = [{k: batch[k][i].numpy() for k in ("article_ids", "image_cls", "face_emb",
                                               "names_art_ids")} for i in range(n)]
    return svc, rows


def test_service_batch_spans(tiny, tmp_path):
    """The batcher runs on its own thread; `profiling.trace` records it."""
    cfg, params, _ = tiny
    svc, rows = _service(cfg, params, 5)
    got = {}

    def serve():
        before = svc.stats()["batches"]
        for group in (rows[:1], rows[1:]):
            for f in [svc.submit(r) for r in group]:
                f.result(timeout=60)
        got["batches"] = svc.stats()["batches"] - before
        # the futures resolve inside serve.respond: join the batcher before
        # the trace stops, or its last spans are cut at the stop
        svc.close()

    try:
        spans = _traced(serve, tmp_path)
    finally:
        svc.close()
    batches = spans["serve.batch"]
    assert got["batches"] >= 2 and len(batches) == got["batches"]
    for n in ("serve.stage", "serve.decode", "serve.respond"):
        assert len(spans[n]) == len(batches), n
        assert all(_within(b, spans[n]) == 1 for b in batches), n
    assert _inside(spans["beam_search.model"], spans["serve.decode"])


def test_service_stacks_rows_outside_the_device_lock(tiny, monkeypatch):
    """Only the device's work holds the lock that `update_params` and
    `precompile` wait on: the host's stacking of the rows does not."""
    cfg, params, _ = tiny
    svc, rows = _service(cfg, params, 3)
    held = []
    real = np.stack
    monkeypatch.setattr(np, "stack",
                        lambda *a, **kw: held.append(svc._device_lock.locked()) or real(*a, **kw))
    try:
        out = svc._decode_rows(rows, bucket=8)
    finally:
        svc.close()
    assert len(out) == 3 and held and not any(held)
    assert not svc._device_lock.locked()
