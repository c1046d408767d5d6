"""Device idle inside the program's own spans, read from a ``TraceView``.

The program opens a ``record_function`` range for each of its stages
(``wsss_tpu_torch.utils.timing.SPANS``, names ``wsss.*``) while a
profiler runs; the ranges land in the same chrome trace as the device
operations.  Autograd launches the backward's kernels from a thread of
its own, so a span's device work is not found by the launch rule of
``TraceView.in_range``: these readers intersect time intervals instead.
A span's idle time is the length of the window less the union of the
device operations' intervals, inside the union of the span's intervals
on any thread.

The trace's device timestamps are not on the host's clock, and how far
they are off differs from process to process: on an H100 under torch
2.11 some processes read them on it to a few us, one ~1 ms before it,
another drifting from 0.2 to 4.1 ms before it over 1.9 s.  So each span
is placed on the device's clock by the offset its neighbourhood shows:
the largest lead of a device operation's start over its launch, among
those launched from ``NEAR_US`` before the span opens until it closes
(a start never precedes its launch; where the device runs behind the
host, no lead shows and the span stays where it is)."""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

NEAR_US = 50_000.0


def _merged(spans) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs, ys) -> float:
    """Length of the intersection of two merged, sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def leads(view) -> List[Tuple[float, float]]:
    """(launch, launch - device start) of the window's device operations
    whose launch the trace holds, in launch order (us)."""
    return sorted((ts, ts - a) for _, a, _, ts, _ in view.device_ops
                  if ts is not None)


def clock_offset(lead, a: float, b: float) -> float:
    """How far (us) the device's clock lies before the host's around the
    host interval [a, b]: the largest of ``lead`` launched from
    ``NEAR_US`` before a until b, or 0."""
    i = bisect.bisect_left(lead, (a - NEAR_US,))
    j = bisect.bisect_right(lead, (b, float('inf')))
    return max([0.0] + [x for _, x in lead[i:j]])


def idle_inside(view, name: str) -> Optional[float]:
    """Seconds of device idle inside the window's spans called ``name``,
    each span placed on the device's clock (``clock_offset``); None where
    the trace has no such span."""
    spans = _merged([(max(a, view.t0), min(b, view.t1))
                     for a, b, _ in view.ranges.get(name, ())])
    if not spans:
        return None
    lead = leads(view)
    busy = _merged([(a, b) for _, a, b, _, _ in view.device_ops])
    ends = [b for _, b in busy]
    idle = 0.0
    for a, b in spans:
        off = clock_offset(lead, a, b)
        k = bisect.bisect_right(ends, a - off)
        idle += (b - a) - overlap([(a - off, b - off)], busy[k:])
    return idle / 1e6


def idle_ms_per(view, name: str, per: str) -> Optional[float]:
    """``idle_inside(view, name)`` in ms over the count of the spans
    called ``per``; None where either is missing."""
    idle = idle_inside(view, name)
    calls = view.range_count(per)
    if idle is None or not calls:
        return None
    return 1e3 * idle / calls
