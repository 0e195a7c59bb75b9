"""Interval arithmetic over a traced run's `Records` for the readers of the
port's own spans (`core/profiling.annotate`: "generate.*",
"beam_search.*", "serve.*"), which arrive in `Records.ranges` beside the
benchmark's window. A program without such spans (an older port) leaves
`present` false, and the readers then return None."""

from __future__ import annotations


def intervals(rec, name: str) -> list:
    """(start_us, end_us) of every span named `name`, by start."""
    return sorted((s, s + d) for n, s, d in rec.ranges if n == name)


def count(rec, name: str) -> int:
    return sum(1 for n, _, _ in rec.ranges if n == name)


def present(rec, name: str) -> bool:
    return rec is not None and any(n == name for n, _, _ in rec.ranges)


def union(spans) -> list:
    """Sorted (start, end) pairs merged where they overlap or touch."""
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def complement(spans, lo: float, hi: float) -> list:
    """[lo, hi] less the union of `spans`."""
    out, cur = [], lo
    for s, e in union((max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def overlap_us(a, b) -> float:
    """The measure of the intersection of two sets of intervals."""
    a, b = union(a), union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_idle(rec) -> list:
    """The traced window less the union of the device's activities."""
    lo, hi = rec.window_us
    return complement([(s, s + d) for _, s, d, _ in rec.device], lo, hi)
