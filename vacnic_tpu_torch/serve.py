"""Online caption serving: dynamic micro-batching over the port's beam
search (port of vacnic_tpu/serve.py).

  submit(sample) -> Future        # any thread
       |  (bounded queue)
  batcher thread: collect up to max_batch requests or until max_wait_ms,
  pick the smallest bucket >= n, pad rows, run ONE generate_mm on the
  device, slice the real rows back into the futures.

Design points:
- Padding is exact: beam search is per-sample independent (each row attends
  only to its own history), so dummy rows cannot change real rows' tokens.
  tests/test_torch_serve.py pins this against a direct `generate_mm` of the
  same padded batch.
- The parameter tree is moved to the service's device once (with a mesh,
  to every device of its data axis), when the service starts and when
  `update_params` swaps it, never per batch.
- One batcher thread issues all device work (with a mesh, through one
  worker thread a device), on one stream a device, and `precompile` /
  `update_params` from a caller's thread take the same device lock. So no
  two launches of a kernel ever run at once on a device: the `lm_stats`
  arrival counters (`kernels/lm_stats.counters`) exist once a device, and
  a service that ran batches on several streams would need a set of them
  for each stream.
- Fixed batch buckets keep every batch at a shape the service has run
  before (`precompile` runs each once): the kernels' launch plans, the
  caching allocator's blocks and the library handles are warm. Buckets
  default to (1, 8, 32, 256): 1 is the latency floor, 256 the throughput
  end of the ladder.
- Spans (`core/profiling.annotate`): the batcher's "serve.wait" (an empty
  queue) and "serve.collect" (a batch held open for arrivals), and one
  "serve.batch" a dispatched batch holding "serve.stage" (stack, pad, the
  device lock, copy, CLIP), "serve.decode" (`generate_mm`, the results to
  the host and their dicts) and "serve.respond" (stats, futures). They
  open on the batcher thread, so only a profiler that records every
  thread (`core/profiling.trace`, or `profile_all_threads`) sees them.

`make_http_server` / `http_serve` put a minimal stdlib HTTP front on the
service (POST /v1/caption, GET /healthz, GET /v1/stats).

`watch_checkpoints` polls a training checkpoint directory and hot-swaps
newer steps into a running service (`cli serve --watch-ckpt-s`).

The service runs on "cuda" unless it is given device="cpu"; without a card
and without that argument it raises. Given a `core/mesh.Mesh` instead, it
serves data-parallel over the mesh's data axis: each bucket goes through
`infer/generate.generate_mm_sharded` (one parameter replica and one host
thread a device, each running the search on its row shard), and every
bucket must divide by the axis's size. Beam search is row-independent, so
a sharded service returns the tokens one device would.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import logging
import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from vacnic_tpu_torch.core.config import VacnicConfig
from vacnic_tpu_torch.core.device import resolve_device
from vacnic_tpu_torch.core.profiling import annotate
from vacnic_tpu_torch.data.synthetic import synthetic_batch
from vacnic_tpu_torch.infer import generate as G
from vacnic_tpu_torch.models import clip_vit
from vacnic_tpu_torch.models.weights_io import tree_to
from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb


def _safe_set(fut: Future, result=None, exc: BaseException | None = None) -> None:
    """Resolve a future, tolerating caller-side cancel()/double-set races:
    a cancelled or already-resolved future makes set_result/set_exception
    raise InvalidStateError, which must never kill the batcher thread."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:  # InvalidStateError (cancelled / already resolved)
        pass


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Micro-batching policy.

    buckets: ascending static batch sizes; arrivals are grouped to the
        smallest bucket that fits and padded to it. Keep the ladder short:
        each bucket is one more shape to warm.
    max_wait_ms: how long the batcher holds an incomplete batch hoping for
        more arrivals. The latency/throughput dial: 0 decodes singletons
        immediately, larger values trade p50 latency for fuller batches.
    max_queue: bound on queued requests; submit raises when full
        (backpressure instead of unbounded memory growth).
    input_kind: "image_cls" (precomputed CLIP CLS features, the loader
        contract) or "pixels" (raw normalised images; the service runs the
        CLIP tower on the batch first).
    default_deadline_ms: if set, every request gets this deadline unless
        submit() passes its own; a request whose deadline has passed when
        its batch is formed is failed fast (TimeoutError on the future)
        instead of occupying a decode slot -- under overload the queue sheds
        stale work instead of decoding captions nobody is waiting for.
    fill_to_stable: when enabled, the batcher additionally WAITS (bounded
        by the stability budget) to fill the stable-target bucket. Off by
        default: with fill waits every cycle's capacity equals the arrivals
        of a cycle over the cycle, so the service runs exactly at the
        offered rate and a backlog never drains, while the no-wait policy
        regulates itself (padding costs less than waiting, and a backlog
        dispatches full-bucket bursts). What IS always on is the
        saturation-aware defer: the batcher never defers down to a bucket
        whose measured capacity cannot cover arrival_rate * stable_margin
        (`_defer_would_saturate`; it costs no wait).
    stable_margin: how far a bucket's nominal capacity (b / decode_ms) must
        exceed the arrival rate. Nominal capacity is optimistic -- each
        cycle also pays collect waits and Python dispatch -- so the margin
        absorbs the cycle's non-decode time.
    """

    buckets: tuple[int, ...] = (1, 8, 32, 256)
    max_wait_ms: float = 10.0
    max_queue: int = 4096
    input_kind: str = "image_cls"
    default_deadline_ms: float | None = None
    fill_to_stable: bool = False
    stable_margin: float = 1.5


def _structure(tree: Any):
    """A hashable description of a tree's containers and keys (leaves as *)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return "*"


def _leaves(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the order of `_structure`."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree) for pl in _leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


class CaptionService:
    """Thread-safe micro-batching front over the port's `generate_mm`.

    `params` is the model param tree ({"model": ..., "clip": ...} as built by
    `models.fusion.multimodal_bart_init` / `models.clip_vit.clip_vision_init`
    or converted by `models.weights_io`; "clip" only needed for pixels
    input). It is moved to `device` once, here. `tokenizer` (optional) turns
    token rows into caption strings. Batches run in
    `cfg.train.compute_dtype` (bf16 or f32).
    """

    def __init__(self, cfg: VacnicConfig, params: dict, *, tokenizer=None,
                 serve_cfg: ServeConfig | None = None, device=None, mesh=None,
                 data_axis: str = "data"):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.scfg = serve_cfg or ServeConfig()
        # With a mesh the batcher dispatches each bucket through
        # generate_mm_sharded over `data_axis`; the batch is staged, and the
        # CLIP tower (pixels) runs, on the axis's first device, as JAX's
        # service runs them before the scatter.
        self.mesh = mesh
        self.data_axis = data_axis
        if not self.scfg.buckets or list(self.scfg.buckets) != sorted(
                set(self.scfg.buckets)):
            raise ValueError(f"buckets must be ascending and unique, got "
                             f"{self.scfg.buckets}")
        if self.scfg.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got "
                             f"{self.scfg.buckets}")
        if mesh is not None:
            axes = mesh.shape
            if data_axis not in axes:
                raise ValueError(f"mesh has no {data_axis!r} axis "
                                 f"(axes: {sorted(axes)})")
            dp = axes[data_axis]
            bad = [b for b in self.scfg.buckets if b % dp]
            if bad:
                raise ValueError(
                    f"sharded serving: buckets {bad} not divisible by the "
                    f"{data_axis!r} mesh axis ({dp} devices)")
            if device is not None:
                raise ValueError("CaptionService: pass a mesh or a device, not both")
            self.device = mesh.data_devices(data_axis)[0]
        else:
            self.device = resolve_device(device)
        if self.scfg.input_kind not in ("image_cls", "pixels"):
            raise ValueError(f"unknown input_kind {self.scfg.input_kind!r}")
        self._dtype = (torch.bfloat16 if cfg.train.compute_dtype == "bfloat16"
                       else torch.float32)
        self.params = self._place(params)
        self._q: queue.Queue = queue.Queue(maxsize=self.scfg.max_queue)
        self._closed = threading.Event()
        self._lock = threading.Lock()
        # serializes ALL device work (batcher dispatches, precompile and
        # update_params from any caller thread): one issuer at a time
        self._device_lock = threading.Lock()
        self._stats = {
            "requests": 0, "batches": 0, "padded_rows": 0, "errors": 0,
            "expired": 0, "weights_version": 0, "deferred_rows": 0,
            "bucket_counts": {int(b): 0 for b in self.scfg.buckets},
            "wait_ms_sum": 0.0, "decode_ms_sum": 0.0,
        }
        # per-request end-to-end latency (submit -> future resolved), bounded
        # ring so stats() can report percentiles without unbounded growth
        self._lat_ring: collections.deque = collections.deque(maxlen=4096)
        # fill-to-stable state: arrival timestamps (2 s sliding window) and
        # per-bucket decode-time EWMAs (seeded by precompile)
        self._arrivals: collections.deque = collections.deque(maxlen=1024)
        self._bucket_ms: dict[int, float] = {}
        self._expected = self._expected_shapes()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="vacnic-serve-batcher")
        self._worker.start()

    def _place(self, params: dict) -> dict:
        """The tree on the service's device and, with a mesh, its model's
        replica on every device of the data axis (made here, once)."""
        params = tree_to(params, self.device)
        if self.mesh is not None:
            G.replicate(params["model"], self.mesh, self.data_axis)
        return params

    # -- request side --------------------------------------------------------

    def _expected_shapes(self) -> dict[str, tuple[tuple[int, ...], Any]]:
        c, f, d = self.cfg, self.cfg.fusion, self.cfg.data
        exp: dict[str, tuple[tuple[int, ...], Any]] = {
            "article_ids": ((d.article_max_length,), np.int32),
        }
        if self.scfg.input_kind == "pixels":
            exp["pixels"] = ((c.clip.image_size, c.clip.image_size, 3),
                             np.float32)
        else:
            exp["image_cls"] = ((f.img_size,), np.float32)
        if not f.only_image:
            exp["face_emb"] = ((f.max_faces, f.face_feature_dim), np.float32)
            exp["names_art_ids"] = ((f.max_ner_type_len,), np.int32)
        return exp

    def submit(self, sample: dict[str, Any], *,
               deadline_ms: float | None = None) -> Future:
        """Enqueue one request. `sample` holds per-sample arrays (no batch
        dim) matching the batch contract: article_ids, image_cls|pixels, and
        (full model) face_emb + names_art_ids. Returns a Future resolving to
        {"tokens": list[int], "score": float, "caption": str|None}.

        `deadline_ms` (else ServeConfig.default_deadline_ms) bounds how stale
        the request may be when its batch forms: past-deadline requests fail
        fast with TimeoutError instead of occupying a decode slot.

        Raises immediately (not via the future) on a malformed sample or a
        full queue, so bad input never ties up the batcher."""
        if self._closed.is_set():
            raise RuntimeError("CaptionService is closed")
        clean = {}
        for key, (shape, dt) in self._expected.items():
            if key not in sample:
                raise ValueError(f"sample missing {key!r} "
                                 f"(expected keys: {sorted(self._expected)})")
            try:
                arr = np.asarray(sample[key], dtype=dt)
            except (TypeError, ValueError) as e:
                # np raises TypeError on nulls/objects -- normalize to the
                # validation error type callers (and the HTTP 400 path) expect
                raise ValueError(f"{key}: not convertible to {np.dtype(dt).name}"
                                 f" ({e})") from e
            if arr.shape != shape:
                raise ValueError(f"{key}: expected shape {shape}, "
                                 f"got {arr.shape}")
            clean[key] = arr
        extra = set(sample) - set(self._expected)
        if extra:
            raise ValueError(f"unexpected sample keys: {sorted(extra)}")
        fut: Future = Future()
        dl_ms = (deadline_ms if deadline_ms is not None
                 else self.scfg.default_deadline_ms)
        if dl_ms is not None:
            try:  # untrusted over HTTP: bool/str/list must be a 400, not a
                # TypeError escaping the handler with a dropped connection
                dl_ms = float(dl_ms)
            except (TypeError, ValueError) as e:
                raise ValueError(f"deadline_ms: not a number ({e})") from e
            if not math.isfinite(dl_ms):
                # NaN passes float() but `now > NaN` is always False -- the
                # request would get a deadline that never expires, silently
                # bypassing the shed policy (and the configured default)
                raise ValueError(f"deadline_ms: must be finite, got {dl_ms}")
        deadline = (time.monotonic() + dl_ms / 1e3
                    if dl_ms is not None else None)
        with self._lock:  # _arrival_rate iterates; unlocked appends from
            # HTTP threads would raise "deque mutated during iteration"
            self._arrivals.append(time.monotonic())
        try:
            self._q.put_nowait((clean, fut, time.monotonic(), deadline))
        except queue.Full:
            raise RuntimeError(
                f"serve queue full ({self.scfg.max_queue}); retry later")
        if self._closed.is_set():
            # close() may have drained and the worker exited between the
            # top-of-method check and the put -- nobody would ever resolve
            # this future. Fail it here; if the worker DID pick it up,
            # whichever side resolves first wins (_safe_set is idempotent).
            _safe_set(fut, exc=RuntimeError("service closed"))
        return fut

    def caption(self, sample: dict[str, Any], timeout: float | None = None):
        """Blocking convenience wrapper around submit()."""
        return self.submit(sample).result(timeout=timeout)

    def update_params(self, params: dict) -> int:
        """Hot-swap model weights without restarting the service (checkpoint
        rollout). The new tree is moved to the device (with a mesh: to every
        device of the data axis, the old replicas dropped) and swapped in
        under the device lock, so it lands between batch dispatches --
        in-flight batches finish on the old weights, every later batch uses
        the new ones on every replica. Returns the new weights version (also
        reported by stats()).

        The new tree must match the served one in structure and in every
        leaf's shape and dtype (a different dtype would change the batches'
        numerics, a different shape crash the batcher), so a mismatch fails
        fast here, before anything is swapped."""
        old_struct, new_struct = _structure(self.params), _structure(params)
        if new_struct != old_struct:
            raise ValueError(f"update_params: tree structure mismatch "
                             f"(got {new_struct}, serving {old_struct})")
        for (path, o), (_, nw) in zip(_leaves(self.params), _leaves(params)):
            os_, ns = tuple(np.shape(o)), tuple(np.shape(nw))
            od, nd = getattr(o, "dtype", None), getattr(nw, "dtype", None)
            if os_ != ns or od != nd:
                raise ValueError(
                    f"update_params: leaf {path} mismatch "
                    f"(shape {ns} vs {os_}, dtype {nd} vs {od})")
        with self._device_lock:
            old, self.params = self.params, self._place(params)
            if self.mesh is not None:
                G.drop_replicas(old["model"])
            with self._lock:
                self._stats["weights_version"] += 1
                return self._stats["weights_version"]

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
            s["bucket_counts"] = dict(self._stats["bucket_counts"])
        n = max(1, s["batches"])
        s["mean_wait_ms"] = s.pop("wait_ms_sum") / max(1, s["requests"])
        s["mean_decode_ms"] = s.pop("decode_ms_sum") / n
        s["queue_depth"] = self._q.qsize()
        with self._lock:
            lat = np.asarray(self._lat_ring)
        if lat.size:  # end-to-end latency percentiles (last <= 4096 requests)
            for p in (50, 95, 99):
                s[f"latency_p{p}_ms"] = round(float(np.percentile(lat, p)), 1)
        with self._lock:  # _dispatch inserts first-seen buckets concurrently
            bms = dict(self._bucket_ms)
        s["bucket_decode_ms"] = {b: round(v, 1) for b, v in sorted(bms.items())}
        r = self._arrival_rate()
        s["arrival_rate_rps"] = round(r, 1) if r is not None else None
        return s

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work and join the batcher. The BATCHER drains the
        queue on its way out (pending requests fail with RuntimeError) -- the
        queue has exactly one consumer at all times, so close() never races
        it. If the worker is still mid-decode after `timeout` (a first batch
        also builds the kernel library), warn and return; the worker
        finishes, drains, and exits on its own."""
        if self._closed.is_set():
            return
        self._closed.set()
        try:  # wake the batcher if it's blocked on get(); best-effort -- the
            # worker re-checks _closed every 100 ms regardless
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            import warnings

            warnings.warn(
                f"CaptionService.close: batcher still running after "
                f"{timeout}s (in-flight decode); it will drain and "
                f"exit when the device call returns", stacklevel=2)

    # -- batcher side ---------------------------------------------------------

    def precompile(self, buckets: tuple[int, ...] | None = None) -> None:
        """Warm every bucket: decode one synthetic batch per bucket twice,
        and seed the fill-to-stable decode-time estimate from the second,
        warm run. There is no compile cache to fill on the card: the first
        run builds and loads the kernel library if no call has yet, creates
        the library handles and grows the caching allocator to the bucket's
        shapes, so the first real request pays none of it. Run before
        exposing the service."""
        for b in buckets or self.scfg.buckets:
            batch = synthetic_batch(
                self.cfg, b, seed=0,
                with_pixels=self.scfg.input_kind == "pixels")
            rows = [{k: batch[k][i].numpy() for k in self._expected}
                    for i in range(b)]
            self._decode_rows(rows)
            t0 = time.monotonic()
            self._decode_rows(rows)
            with self._lock:
                self._bucket_ms.setdefault(int(b), (time.monotonic() - t0) * 1e3)

    def _run(self) -> None:
        carry: list = []
        while not self._closed.is_set():
            if carry:
                # deferred remainder from the last dispatch: top up from
                # already-queued arrivals WITHOUT waiting (they have waited
                # their share already) and go straight back to dispatch
                items = carry
                carry = []
                while len(items) < self.scfg.buckets[-1]:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        break
                    items.append(nxt)
            else:
                try:
                    with annotate("serve.wait"):
                        first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if first is None:
                    continue
                # fill-to-stable applies to freshly-collected batches only:
                # carried remainders are promised to go straight back to
                # dispatch (holding them an extra fill wait would convert
                # deferrals into deadline sheds under exactly the load the
                # defer policy targets)
                with annotate("serve.collect"):
                    items = self._fill_to_stable(self._collect(first))
            carry = self._dispatch_or_defer(items)
        # sole-consumer drain on exit: fail whatever is still queued/carried
        for item in carry:
            _safe_set(item[1], exc=RuntimeError("service closed"))
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _safe_set(item[1], exc=RuntimeError("service closed"))

    def _collect(self, first) -> list:
        items = [first]
        max_b = self.scfg.buckets[-1]
        deadline = time.monotonic() + self.scfg.max_wait_ms / 1e3
        while len(items) < max_b:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    # -- fill-to-stable --------------------------------------------------------

    def _arrival_rate(self, window_s: float = 2.0) -> float | None:
        """Requests/sec over the trailing window; None below 4 arrivals
        (not enough signal to justify holding anyone's request)."""
        now = time.monotonic()
        with self._lock:  # submit() appends concurrently
            n = sum(1 for t in reversed(self._arrivals) if t > now - window_s)
        return n / window_s if n >= 4 else None

    def _stable_target(self, rate: float) -> tuple[int, float | None]:
        """Smallest bucket whose measured capacity (b / decode_time) covers
        rate * stable_margin; the largest bucket if none does (max
        throughput is the best a saturated service can offer). Unknown
        decode times fall back to the nearest smaller bucket's (optimistic --
        self-corrects after one dispatch)."""
        d_prev = None
        for b in self.scfg.buckets:
            d = self._bucket_ms.get(b, d_prev)
            if d is None:
                continue
            d_prev = d
            if b / (d / 1e3) >= rate * self.scfg.stable_margin:
                return b, d
        b = self.scfg.buckets[-1]
        return b, self._bucket_ms.get(b, d_prev)

    def _fill_to_stable(self, items: list) -> list:
        """Under sustained load (more than one request in the collected
        batch), extend collection until the stability-target bucket is full.
        The wait is bounded by the STABILITY BUDGET -- target/(rate*margin)
        minus the target's decode time -- so filling can never push the
        cycle's capacity below the margin the target was chosen for. n == 1
        never waits: closed-loop latency unchanged."""
        n = len(items)
        if not self.scfg.fill_to_stable or n <= 1:
            return items
        if not self._bucket_ms:
            return items  # no decode-time data yet: nothing to reason with
        rate = self._arrival_rate()
        if rate is None:
            return items
        target, d_ms = self._stable_target(rate)
        if n >= target:
            return items
        fill_s = (target - n) / rate * 1.25
        # the fill wait is part of the service cycle: capacity with fill is
        # target / (decode + fill), so the fill budget is what keeps that
        # capacity at rate*margin -- NOT "one decode time", which lets a
        # cycle of one fill plus one decode run exactly at the offered rate
        budget_s = target / (rate * self.scfg.stable_margin)
        if d_ms is not None:
            budget_s -= d_ms / 1e3
        fill_s = min(fill_s, budget_s)
        if fill_s <= 0:
            return items
        deadline = time.monotonic() + fill_s
        while len(items) < target and not self._closed.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _shed_expired(self, items: list) -> list:
        """Fail past-deadline requests fast (TimeoutError) and return only
        live ones. Runs BEFORE the defer split so a live request is never
        deferred behind a dispatch of mostly-expired rows and the bucket
        choice reflects the rows that will actually decode."""
        now = time.monotonic()
        expired = [it for it in items if it[3] is not None and now > it[3]]
        if not expired:
            return items
        with self._lock:
            self._stats["expired"] += len(expired)
        for _, fut, t_in, _dl in expired:
            _safe_set(fut, exc=TimeoutError(
                f"request deadline exceeded before dispatch "
                f"(waited {(now - t_in) * 1e3:.0f} ms)"))
        return [it for it in items if it[3] is None or now <= it[3]]

    def _dispatch_or_defer(self, items: list) -> list:
        """Defer-to-fill: when the collected count n lands between buckets
        and the remainder after the lower bucket is SMALL (smaller than both
        the lower bucket and the padding the upper bucket would burn),
        dispatch the lower bucket full of real rows and carry the remainder
        into the immediately-following batch, instead of padding a backlog
        of, say, 9-31 requests to the 32-bucket. Light load is unchanged --
        with n at or below the smallest bucket the policy degenerates to
        pad-and-send."""
        items = self._shed_expired(items)
        if not items:
            return []
        n = len(items)
        bs = self.scfg.buckets
        b_down = max((b for b in bs if b <= n), default=None)
        b_up = next((b for b in bs if b >= n), None)
        if (b_down is not None and b_up is not None and n != b_up
                and (n - b_down) < min(b_up - n, b_down)
                and not self._defer_would_saturate(n, b_down)):
            with self._lock:
                self._stats["deferred_rows"] += n - b_down
            self._dispatch(items[:b_down])
            return items[b_down:]
        self._dispatch(items)
        return []

    def _defer_would_saturate(self, n: int, b_down: int) -> bool:
        """True when deferring down to b_down-sized dispatches cannot keep
        up with the measured arrival rate. Without this check the defer
        policy is SELF-SUSTAINING under saturation: dispatch b_down, carry
        the remainder, one dispatch-time of arrivals lands the next batch
        back in the defer band, forever -- batches pin at b_down while the
        queue and p50 grow without bound. When the stable-target bucket
        exceeds b_down, dispatch the whole batch padded upward instead
        (throughput over padding efficiency)."""
        if n <= 1 or not self._bucket_ms:
            return False
        rate = self._arrival_rate()
        if rate is None:
            return False
        target, _ = self._stable_target(rate)
        return target > b_down

    def _dispatch(self, items: list) -> None:
        with annotate("serve.batch"):
            now = time.monotonic()
            n = len(items)
            bucket = next((b for b in self.scfg.buckets if b >= n),
                          self.scfg.buckets[-1])
            try:
                t0 = time.monotonic()
                results = self._decode_rows([it[0] for it in items], bucket=bucket)
                decode_ms = (time.monotonic() - t0) * 1e3
            except Exception as e:  # surface to every caller in the batch
                with self._lock:
                    self._stats["errors"] += n
                for _, fut, *_ in items:
                    _safe_set(fut, exc=e)
                return
            done = time.monotonic()
            with annotate("serve.respond"):
                with self._lock:
                    old = self._bucket_ms.get(int(bucket))
                    self._bucket_ms[int(bucket)] = (decode_ms if old is None
                                                    else 0.7 * old + 0.3 * decode_ms)
                    self._stats["requests"] += n
                    self._stats["batches"] += 1
                    self._stats["padded_rows"] += bucket - n
                    self._stats["bucket_counts"][int(bucket)] += 1
                    self._stats["wait_ms_sum"] += sum(
                        (now - t_in) * 1e3 for _, _, t_in, _dl in items)
                    self._stats["decode_ms_sum"] += decode_ms
                    self._lat_ring.extend((done - t_in) * 1e3 for _, _, t_in, _dl in items)
                for res, (_, fut, *_) in zip(results, items):
                    _safe_set(fut, result=res)

    def _decode_rows(self, rows: list[dict], bucket: int | None = None
                     ) -> list[dict]:
        """Stack sample rows, pad to `bucket` by repeating row 0 (results for
        pad rows are sliced off -- beam decode is row-independent so padding
        cannot perturb real rows), run the CLIP tower (pixels input) and one
        `generate_mm` on the service's device (with a mesh, one
        `generate_mm_sharded` over it). Holds _device_lock, under
        torch.inference_mode() (grad mode is a thread's own): precompile()
        (caller thread) and the batcher never issue device work
        concurrently."""
        n = len(rows)
        bucket = bucket or n
        with contextlib.ExitStack() as on_device:
            with annotate("serve.stage"):
                batch = {}
                for key in self._expected:
                    stacked = np.stack([r[key] for r in rows])
                    if bucket > n:
                        pad = np.repeat(stacked[:1], bucket - n, axis=0)
                        stacked = np.concatenate([stacked, pad], axis=0)
                    batch[key] = torch.from_numpy(stacked)
                # the device from the copies in to the results' copy out: the
                # host's stacking above and its dicts below stay unlocked
                on_device.enter_context(self._device_lock)
                on_device.enter_context(torch.inference_mode())
                batch = {k: v.to(self.device) for k, v in batch.items()}
                if self.scfg.input_kind == "pixels":
                    _, img_cls = clip_vit.clip_vision_fwd(self.params["clip"], batch["pixels"],
                                                          self.cfg.clip, self._dtype)
                else:
                    img_cls = batch["image_cls"]
                kwargs = {}
                if not self.cfg.fusion.only_image:
                    kwargs = dict(
                        face_features=batch["face_emb"],
                        face_mask=face_mask_from_emb(batch["face_emb"]),
                        name_ids=batch["names_art_ids"],
                        name_mask=create_mask(batch["names_art_ids"]),
                    )
                src = batch["article_ids"]
            with annotate("serve.decode"):
                if self.mesh is not None:
                    seqs, scores = G.generate_mm_sharded(
                        self.mesh, self.params["model"], src, create_mask(src),
                        img_cls, self.cfg.bart, self.cfg.fusion, self.cfg.decode,
                        dtype=self._dtype, data_axis=self.data_axis, **kwargs)
                else:
                    seqs, scores = G.generate_mm(
                        self.params["model"], src, create_mask(src), img_cls,
                        self.cfg.bart, self.cfg.fusion, self.cfg.decode,
                        dtype=self._dtype, device=self.device, **kwargs)
                seqs = seqs[:n].cpu().numpy()
                scores = scores[:n].float().cpu().numpy()
                on_device.close()
                out = []
                for i in range(n):
                    caption = None
                    if self.tokenizer is not None:
                        caption = self.tokenizer.decode(seqs[i],
                                                        skip_special_tokens=True)
                    out.append({"tokens": [int(t) for t in seqs[i]],
                                "score": float(scores[i]), "caption": caption})
        return out


def watch_checkpoints(service: CaptionService, directory: str, load_params,
                      *, poll_s: float = 30.0,
                      initial_step: int | None = None) -> threading.Thread:
    """Continuous checkpoint rollout: poll `directory` (a
    train/checkpoints.CheckpointManager directory) for a newer training step
    and hot-swap its weights into the running service
    (`CaptionService.update_params`, between batches).

    `load_params(step) -> params` does the restore (the caller owns the
    restore path and its config; cli serve passes its own). `initial_step`
    is the step the service already serves (only newer steps swap); None
    swaps on the first checkpoint seen, right for a --random-init service
    warming up while training runs. The thread stops when the service
    closes; restore errors are logged and retried at the next poll, never
    fatal to serving."""
    log = logging.getLogger(__name__)

    def loop() -> None:
        from vacnic_tpu_torch.train import checkpoints

        last = initial_step
        while not service._closed.wait(poll_s):
            try:
                mgr = checkpoints.CheckpointManager(directory)
                try:
                    step = mgr.latest_step()
                finally:
                    mgr.close()
                if step is None or (last is not None and step <= last):
                    continue
                version = service.update_params(load_params(step))
                last = step
                log.info("serving weights hot-swapped to checkpoint step %d "
                         "(weights_version %d)", step, version)
            except Exception:
                log.warning("checkpoint watch poll failed; retrying",
                            exc_info=True)

    t = threading.Thread(target=loop, daemon=True, name="vacnic-ckpt-watch")
    t.start()
    return t


# ---------------------------------------------------------------------------
# Minimal stdlib HTTP front-end
# ---------------------------------------------------------------------------

LISTEN_BACKLOG = 1024  # pending connections the HTTP socket queues


def make_http_server(service: CaptionService, host: str = "127.0.0.1",
                     port: int = 0):
    """Build (not start) a ThreadingHTTPServer bound to the service.

    Routes: POST /v1/caption (JSON sample -> JSON result), GET /healthz,
    GET /v1/stats. Returns the server; call .serve_forever() (blocking) or
    run it in a thread; .server_address[1] is the bound port (port=0 picks an
    ephemeral one). Status codes: 200; 400 for a malformed sample or
    deadline; 404 for another route; 500 when the decode failed; 503 when
    the queue is full or the service closed; 504 when the request's deadline
    passed before its batch formed.

    The socket listens with a backlog of LISTEN_BACKLOG connections: the
    stdlib's default of 5 resets a burst of a few hundred clients that
    connect at once."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        request_queue_size = LISTEN_BACKLOG

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib handler naming)
            if self.path == "/healthz":
                alive = (not service._closed.is_set()
                         and service._worker.is_alive())
                self._send(200 if alive else 503, {"ok": alive})
            elif self.path == "/v1/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/caption":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                sample = json.loads(self.rfile.read(length) or b"{}")
                dl = (sample.pop("deadline_ms", None)
                      if isinstance(sample, dict) else None)
                fut = service.submit(sample, deadline_ms=dl)
            except ValueError as e:  # malformed sample -> client error
                self._send(400, {"error": str(e)})
                return
            except RuntimeError as e:  # queue full / closed -> retryable
                self._send(503, {"error": str(e)})
                return
            try:
                self._send(200, fut.result())
            except TimeoutError as e:  # deadline shed -> gateway timeout
                self._send(504, {"error": str(e)})
            except RuntimeError as e:
                if str(e) == "service closed":  # retryable elsewhere
                    self._send(503, {"error": str(e)})
                else:  # decode-side failure
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # decode-side failure
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet by default
            pass

    return Server((host, port), Handler)


def http_serve(service: CaptionService, host: str = "127.0.0.1",
               port: int = 8500) -> None:
    """Blocking HTTP serve loop. SIGTERM (the normal orchestrator stop
    signal) triggers the same graceful shutdown as Ctrl-C: stop accepting,
    drain the batcher, close."""
    import signal

    srv = make_http_server(service, host, port)
    print(f"serving on http://{srv.server_address[0]}:{srv.server_address[1]} "
          f"(buckets={service.scfg.buckets}, "
          f"max_wait_ms={service.scfg.max_wait_ms}, device={service.device})")
    prev = None
    try:  # main thread only; http_serve from a helper thread skips this
        # shutdown() blocks until serve_forever exits, and the handler runs
        # ON the serve_forever thread -- call it from a helper thread or the
        # handler deadlocks against its own loop
        prev = signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
            target=srv.shutdown, daemon=True).start())
    except ValueError:
        pass
    try:
        srv.serve_forever()
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        srv.server_close()
        service.close()
