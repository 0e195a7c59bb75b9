"""The traced part of a run: `torch.profiler` (CPU and CUDA activity) over
a few units of the cell's work, its Chrome trace read back into `Records`,
which the per-layer metric readers (portbench/metrics) and the breakdown
take their numbers from.

What a record holds: every device activity (kernels, copies, fills) with
its start, duration and the correlation id of its launch; every launch's
host time by that id; the user ranges (`record_function`) and the CPU ops.
Device busy time is the union of the device activities' intervals; the
traced window is the host's time from the first unit's start to the last
unit's end, after a synchronise."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Records:
    device: list            # (name, start_us, dur_us, correlation) of each device activity
    launches: dict          # correlation -> host time of the launch (us)
    ranges: list            # (name, start_us, dur_us) of user ranges
    cpu_ops: list           # (name, start_us, dur_us, tid)
    window_us: tuple        # (start, end) on the trace's clock
    units: int = 0          # units of the cell's work inside the window
    extra: dict = dataclasses.field(default_factory=dict)  # the driver's numbers

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds inside the window in which some device activity ran."""
        lo, hi = self.window_us
        spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d, _ in self.device
                       if s + d > lo and s < hi)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def idle_pct(self) -> float | None:
        """The share of the window in which no device activity ran; None
        where the trace holds no device activity (no card)."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def roofline_pct(self, match, least_s: float, launches: int) -> float | None:
        """100 x least_s over the device time of the activities `match`
        accepts, or None where their launches are not the `launches` that
        least_s counts (the work moved to another kernel, or no card)."""
        secs, n = self.kernel_seconds(match)
        if n != launches or secs <= 0:
            return None
        return 100.0 * least_s / secs

    def kernel_seconds(self, match) -> tuple[float, int]:
        """(seconds, launches) of the device activities whose name `match`
        accepts."""
        sel = [d for name, _, d, _ in self.device if match(name)]
        return sum(sel) / 1e6, len(sel)

    def seconds_by_range(self, range_name: str) -> float:
        """Device seconds of the activities launched while a user range of
        that name was open (any thread): a kernel belongs to the range in
        which the host launched it, wherever it ran."""
        spans = sorted((s, s + d) for n, s, d in self.ranges if n == range_name)
        if not spans:
            return 0.0
        import bisect

        starts = [s for s, _ in spans]
        total = 0.0
        for _, _, dur, corr in self.device:
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                total += dur
        return total / 1e6

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, _, d, _ in self.device:
            by[name] = by.get(name, 0.0) + d / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time inside the window by what the host was
        doing: each gap between device activities is named by the
        innermost CPU op or user range of the main thread (the one with the
        most ops) open at its middle, and the gaps of one name summed; the
        n largest."""
        lo, hi = self.window_us
        spans = sorted((s, s + d) for _, s, d, _ in self.device if s + d > lo and s < hi)
        gaps, cur = [], lo
        for s, e in spans:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        tids: dict = {}
        for _, _, _, tid in self.cpu_ops:
            tids[tid] = tids.get(tid, 0) + 1
        main = max(tids, key=tids.get) if tids else None
        host = sorted([(s, -(s + d), n) for n, s, d, t in self.cpu_ops if t == main]
                      + [(s, -(s + d), n) for n, s, d in self.ranges])
        by: dict[str, float] = {}
        stack: list = []
        i = 0
        for g0, g1 in sorted(gaps):
            mid = (g0 + g1) / 2
            while i < len(host) and host[i][0] <= mid:
                s, neg_e, name = host[i]
                while stack and stack[-1][0] < s:
                    stack.pop()
                stack.append((-neg_e, name))
                i += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            label = stack[-1][1] if stack else "(python, no op open)"
            by[label] = by.get(label, 0.0) + (g1 - g0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def capture(work, units: int, sync) -> Records:
    """Run `work()` (one unit of the cell's work) `units` times under the
    profiler, `sync()` before and after, and read the trace back."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        sync()
        with torch.profiler.record_function("portbench.window"):
            for _ in range(units):
                work()
            sync()
    return read_profile(prof, units)


def read_profile(prof, units: int) -> Records:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return records_from_events(events, units)


def records_from_events(events: list, units: int) -> Records:
    device, launches, ranges, cpu_ops = [], {}, [], []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((name, ts, dur, corr))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation":
            if name == "portbench.window":
                window = (ts, ts + dur)
            else:
                ranges.append((name, ts, dur))
        elif cat == "cpu_op":
            cpu_ops.append((name, ts, dur, e.get("tid")))
    if window is None:
        window = (0.0, 0.0)
    return Records(device=device, launches=launches, ranges=ranges, cpu_ops=cpu_ops,
                   window_us=window, units=units)
