"""The caption service under open-loop load: single requests (one article
with its CLIP CLS feature, faces and names) submitted to an in-process
`serve.CaptionService` with the default `ServeConfig()` at a fixed Poisson
rate, whatever the service keeps up with.

The arrivals: `rate_rps` x --seconds requests whose gaps are one fixed set
of exponential draws (from `arrival_seed`, the same in every run), put in
an order drawn from --seed, so every seed offers the same load; the
articles are drawn from --seed. One thread submits each request at its due
time and notes how late it ran; a request's latency runs from its due
time to the moment its answer was set.

Set-up: the kernel library, the weights (bf16) from the cell's
`weight_seed` (one model for every --seed, as in the captioning cells),
the service and its `precompile()` (every bucket twice). Window: the requests due in
the first --seconds; the run waits for every answer up to `drain_s` past
the window's end. A request refused (queue full), failed or unanswered
counts as missing every limit: its latency is the wait until the run gave
it up.

End-to-end: serve_latency_p95_ms (over every request due in the window),
setup_s. Per-layer (--trace 1): the service's padding share and mean queue
wait over the window (stats() before and after), and the device's idle
share over `trace_seconds` more of the same load under the profiler.

Correct: every request answered, and `check_rows` answers drawn from the
seed held to the plain reference as the captioning cells hold theirs
(drivers/caption_closed.py): the widest gap in nats between the service's
score x length**lp and the reference's sum of the same tokens'
log-probabilities."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench import harness, weights
from portbench.drivers import caption_closed as cap
from portbench.trace import capture
from portbench.traffic.synthetic import synthetic_batch

ROW_KEYS = ("article_ids", "image_cls", "face_emb", "names_art_ids")


def arrivals(spec: dict, seed: int, seconds: float, rate: float | None = None) -> np.ndarray:
    """Due times (s from the window's start) of the requests due in
    `seconds`: a fixed set of exponential gaps, ordered by `seed`."""
    rate = float(rate or spec["rate_rps"])
    n = int(round(rate * seconds))
    gaps = np.random.RandomState(int(spec["arrival_seed"])).exponential(1.0 / rate, n)
    gaps *= seconds / gaps.sum()  # the n requests span the window
    order = np.random.RandomState(seed % (2 ** 32)).permutation(n)
    return np.cumsum(gaps[order]) - gaps[order][0]


def make_rows(ctx, n: int, keys) -> tuple[list[dict], dict]:
    """n distinct requests from the seed (numpy rows) and the same rows as
    stacked tensors on the device (the reference's inputs)."""
    s = ctx.sizes
    chunks = [synthetic_batch(s, min(512, n - i), seed=ctx.sub_seed(1, i // 512))
              for i in range(0, n, 512)]
    cat = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    rows = [{k: cat[k][i] for k in keys} for i in range(n)]
    return rows, harness.model_inputs(cat, ctx.device, s["only_image"])


class Load:
    """One open-loop pass: submits rows at their due times from a thread of
    its own, and records each request's due, submit and answer times."""

    def __init__(self, service, rows: list[dict], due: np.ndarray):
        self.service, self.rows, self.due = service, rows, due
        n = len(due)
        self.submitted = np.full(n, np.nan)
        self.answered = np.full(n, np.nan)
        self.results: list = [None] * n
        self.refused = np.zeros(n, bool)
        self.futures: list = [None] * n
        self.t0 = None

    def _on_done(self, i: int, fut) -> None:
        self.answered[i] = time.perf_counter() - self.t0
        if fut.exception() is None:
            self.results[i] = fut.result()

    def _submit_all(self) -> None:
        for i, t in enumerate(self.due):
            wait = t - (time.perf_counter() - self.t0)
            if wait > 0:
                time.sleep(wait)
            self.submitted[i] = time.perf_counter() - self.t0
            try:
                fut = self.service.submit(self.rows[i % len(self.rows)])
            except RuntimeError:  # the queue is full: refused
                self.refused[i] = True
                continue
            self.futures[i] = fut
            fut.add_done_callback(lambda f, i=i: self._on_done(i, f))

    def run(self, drain_s: float) -> float:
        """Offer the load, wait for the answers (up to drain_s past the
        last due time) -> the seconds from the start to the wait's end."""
        self.t0 = time.perf_counter()
        th = threading.Thread(target=self._submit_all, name="portbench-load")
        th.start()
        th.join()
        end = self.t0 + float(self.due[-1]) + drain_s
        for fut in self.futures:
            if fut is not None:
                try:
                    fut.result(timeout=max(0.0, end - time.perf_counter()))
                except Exception:  # failed or unanswered: counted below
                    pass
        return time.perf_counter() - self.t0

    def latencies_ms(self, gave_up_s: float) -> tuple[np.ndarray, int]:
        """Each request's latency from its due time; a refused, failed or
        unanswered one waited until `gave_up_s`. -> (latencies, failed)."""
        ok = np.array([r is not None for r in self.results])
        lat = np.where(ok, self.answered - self.due, gave_up_s - self.due) * 1e3
        return lat, int((~ok).sum())


def counters(service) -> dict:
    s = service.stats()
    rows = sum(b * c for b, c in s["bucket_counts"].items())
    return {"requests": s["requests"], "padded": s["padded_rows"], "rows": rows,
            "wait_ms_sum": s["mean_wait_ms"] * s["requests"]}


def build(ctx):
    from vacnic_tpu_torch.serve import CaptionService, ServeConfig

    cfg = ctx.port_config()
    if ctx.device.startswith("cuda"):
        from vacnic_tpu_torch.kernels import _build

        _build.lib()
    dtype = torch.bfloat16 if ctx.device.startswith("cuda") else torch.float32
    model = weights.make_model(ctx.sizes, int(ctx.spec["weight_seed"]), ctx.device, dtype)
    service = CaptionService(cfg, {"model": model}, serve_cfg=ServeConfig(), device=ctx.device)
    return service, model


def check(ctx, model, inputs, load: Load) -> float:
    """The widest score gap (nats) of `check_rows` answers drawn from the
    seed, against the plain reference."""
    answered = [i for i, r in enumerate(load.results) if r is not None]
    if not answered:  # nothing to hold to the reference: the check fails
        return 1e9
    rng = np.random.RandomState(ctx.sub_seed(2) % (2 ** 32))
    picks = sorted(rng.choice(answered, size=min(int(ctx.spec["check_rows"]), len(answered)),
                              replace=False))
    n_rows = inputs["input_ids"].shape[0]
    # the captioning driver's arithmetic, one batch of one row an answer
    pool, outs = [], []
    for j, i in enumerate(picks):
        r = int(i) % n_rows
        pool.append({k: (None if v is None else v[r:r + 1]) for k, v in inputs.items()})
        outs.append((j, torch.tensor(load.results[i]["tokens"], device=ctx.device)[None],
                     torch.tensor([load.results[i]["score"]], device=ctx.device)))
    port, ref = cap.sums(ctx, model, pool, outs, [(j, 0) for j in range(len(outs))])
    return float(np.abs(port - ref).max())


def run(ctx: harness.Context) -> harness.Outcome:
    spec = ctx.spec
    service, model = build(ctx)
    try:
        service.precompile()
        due = arrivals(spec, ctx.seed, ctx.seconds)
        rows, inputs = make_rows(ctx, len(due), ROW_KEYS if not ctx.sizes["only_image"]
                                 else ("article_ids", "image_cls"))
        harness.sync(ctx.device)
        setup_s = time.perf_counter() - ctx.t_start
        before = counters(service)
        load = Load(service, rows, due)
        gave_up = load.run(float(spec["drain_s"]))
        after = counters(service)
        lat, failed = load.latencies_ms(gave_up)
        peak = harness.memory_peak(ctx.device)
        late = (load.submitted - load.due) * 1e3

        records = None
        if ctx.trace:
            t_due = arrivals(spec, ctx.seed + 1, float(spec["trace_seconds"]))
            records = capture(lambda: Load(service, rows, t_due).run(float(spec["drain_s"])), 1,
                              lambda: harness.sync(ctx.device))
            records.units = len(t_due)
            d = {k: after[k] - before[k] for k in after}
            records.extra.update(
                serve_pad_pct=100.0 * d["padded"] / d["rows"] if d["rows"] else None,
                serve_wait_ms=d["wait_ms_sum"] / d["requests"] if d["requests"] else None)
    finally:
        service.close()
    gap = check(ctx, model, inputs, load)
    lim = spec["limits"]
    return harness.Outcome(
        e2e={"serve_latency_p95_ms": float(np.percentile(lat, 95)), "setup_s": setup_s},
        attempted=len(due), failed=failed,
        checks=[("unanswered", float(failed), 0.0),
                ("score_gap_nats", gap, float(lim["score_gap_nats"]))],
        memory_peak_bytes=peak, records=records,
        notes={"requests": len(due), "offered_rps": len(due) / ctx.seconds,
               "latency_p50_ms": float(np.percentile(lat, 50)),
               "generator_late_p99_ms": float(np.nanpercentile(late, 99)),
               "refused": int(load.refused.sum())})


def backlog_slope(due: np.ndarray, answered: np.ndarray, t0: float, t1: float) -> float:
    """The least-squares slope (requests/s) over [t0, t1] of the backlog:
    requests due and not yet answered, read every 50 ms."""
    ans = np.sort(np.nan_to_num(answered, nan=np.inf))
    t = np.arange(t0, t1, 0.05)
    backlog = np.searchsorted(np.sort(due), t, "right") - np.searchsorted(ans, t, "right")
    return float(np.polyfit(t, backlog, 1)[0])


def sweep(ctx: harness.Context, rates: list[float], seconds: float, repeats: int) -> list[dict]:
    """The knee's readings (portbench/control.py --sweep): for each rate,
    `repeats` windows of `seconds` of this load, each on arrivals of its
    own; per window, over its last two thirds (the first third fills the
    pipeline), the rate answered and the backlog's slope, and the
    latencies over the whole window."""
    service, _ = build(ctx)
    out = []
    keys = ROW_KEYS if not ctx.sizes["only_image"] else ("article_ids", "image_cls")
    try:
        service.precompile()
        rows, _ = make_rows(ctx, 2048, keys)
        for rate in rates:
            for j in range(repeats):
                due = arrivals(ctx.spec, ctx.seed + j, seconds, rate)
                load = Load(service, rows, due)
                gave_up = load.run(float(ctx.spec["drain_s"]))
                lat, failed = load.latencies_ms(gave_up)
                t0 = seconds / 3
                answered = np.nan_to_num(load.answered, nan=np.inf)
                out.append({"rate_rps": rate, "window": j, "requests": len(due),
                            "answered_rps": float(((answered >= t0) & (answered < seconds)).sum()
                                                  / (seconds - t0)),
                            "backlog_slope_rps": backlog_slope(due, load.answered, t0, seconds),
                            "backlog_at_end": int((answered > seconds).sum()),
                            "p50_ms": float(np.percentile(lat, 50)),
                            "p95_ms": float(np.percentile(lat, 95)), "failed": failed})
                print(out[-1], flush=True)
    finally:
        service.close()
    return out
