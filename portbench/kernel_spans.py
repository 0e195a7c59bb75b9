"""Device time of named kernels launched inside the port's spans, for the
readers that split one span's kernels (portbench/metrics/*.led.py): a
kernel belongs to the span in which the host launched it, as
trace.Records.seconds_by_range counts it."""

from __future__ import annotations

import bisect

from portbench import spans


def seconds_in(rec, range_name: str, match) -> tuple[float, int]:
    """(seconds, launches) of the device activities whose name `match`
    accepts and whose launch fell inside a span named `range_name`."""
    opened = spans.intervals(rec, range_name)
    starts = [s for s, _ in opened]
    secs, n = 0.0, 0
    for name, _, dur, corr in rec.device:
        t = rec.launches.get(corr)
        if t is None or not match(name):
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and opened[i][0] <= t <= opened[i][1]:
            secs += dur
            n += 1
    return secs / 1e6, n
