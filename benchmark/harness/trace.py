"""Ranges around the program's layers, opened from the benchmark's own
files, and the reading of a ``torch.profiler`` trace.

``Ranges`` wraps a function where an entry module calls it, or a method
on its class, and hooks network modules: each call opens a
``record_function`` range in a traced run and hands its arguments and
result to an observer (the entries keep the timed path's outputs for the
check that way).  The wrapper returns what the function returned; a
name the program no longer has is skipped, so its metric reads nothing.

``TraceView`` reads the profiler's chrome trace: the device operations
(kernels, memsets, copies) with the host thread and time of their launch,
the ranges, and the aten ops.  A device operation belongs to a range or
an op when its launch lies inside it on the same host thread.  Busy time
is the union of the device operations' intervals inside the window (the
arithmetic of ``scripts/profile_torch_hsn.py``, copied)."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
WINDOW = 'bench.window'


class Ranges:
    """Wrappers and hooks installed for one run, removed on exit."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.counters: Dict[str, float] = defaultdict(float)
        self._undo: List[Callable[[], None]] = []

    def wrap(self, owner, attr: str, name: str,
             observe: Optional[Callable] = None) -> None:
        """Wrap ``owner.attr`` (a module's function, a class's method or an
        object's); nothing where the program has no such name."""
        fn = getattr(owner, attr, None)
        if fn is None:
            return
        traced = self.traced

        def wrapper(*args, **kwargs):
            if traced:
                with torch.profiler.record_function(name):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if observe is not None:
                observe(args, kwargs, out)
            return out
        setattr(owner, attr, wrapper)
        self._undo.append(lambda: setattr(owner, attr, fn))

    def hook(self, module: torch.nn.Module, name: str) -> None:
        """A range around each forward of ``module`` (traced runs)."""
        if not self.traced:
            return
        open_ = []

        def pre(mod, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_.append(rf)

        def post(mod, args, out):
            open_.pop().__exit__(None, None, None)
        hs = [module.register_forward_pre_hook(pre),
              module.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in hs])

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def union_seconds(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (any units)."""
    busy, end = 0.0, float('-inf')
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


class TraceView:
    """The traced window of one run, read from a chrome trace (us)."""

    def __init__(self, events: List[dict]):
        launches = {}
        self.ranges: Dict[str, List[Tuple[float, float, int]]] = \
            defaultdict(list)
        self.ops: Dict[str, List[Tuple[float, float, int]]] = \
            defaultdict(list)
        dev = []
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat = e.get('cat', '')
            if cat in DEVICE_CATS:
                dev.append(e)
            elif cat in LAUNCH_CATS:
                corr = e.get('args', {}).get('correlation')
                if corr is not None:
                    launches[corr] = (float(e['ts']), e.get('tid'))
            elif cat == 'user_annotation':
                self.ranges[e['name']].append(
                    (float(e['ts']), float(e['ts']) + float(e['dur']),
                     e.get('tid')))
            elif cat == 'cpu_op':
                self.ops[e['name']].append(
                    (float(e['ts']), float(e['ts']) + float(e['dur']),
                     e.get('tid')))
        win = self.ranges.get(WINDOW)
        if not win:
            raise ValueError('the trace holds no window range')
        self.t0, self.t1 = win[0][0], win[0][1]
        self.window_s = (self.t1 - self.t0) / 1e6
        self.device_ops = []        # (name, start, end, launch_ts, tid)
        for e in dev:
            a = float(e['ts'])
            b = a + float(e.get('dur', 0.0))
            if b <= self.t0 or a >= self.t1:
                continue
            ts, tid = launches.get(e.get('args', {}).get('correlation'),
                                   (None, None))
            self.device_ops.append((e['name'], max(a, self.t0),
                                    min(b, self.t1), ts, tid))
        self.busy_s = union_seconds(
            [(a, b) for _, a, b, _, _ in self.device_ops]) / 1e6

    def _inside(self, spans) -> List[tuple]:
        by_tid = defaultdict(list)
        for a, b, tid in spans:
            by_tid[tid].append((a, b))
        merged = {}
        for tid, iv in by_tid.items():        # nested spans merge
            out = []
            for a, b in sorted(iv):
                if out and a <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], b)
                else:
                    out.append([a, b])
            merged[tid] = ([a for a, _ in out], [b for _, b in out])
        found = []
        for op in self.device_ops:
            ts, tid = op[3], op[4]
            if ts is None or tid not in merged:
                continue
            starts, ends = merged[tid]
            k = bisect.bisect_right(starts, ts) - 1
            if k >= 0 and ts <= ends[k]:
                found.append(op)
        return found

    def in_range(self, name: str) -> List[tuple]:
        """Device operations launched inside ranges called ``name``."""
        return self._inside(self.ranges.get(name, []))

    def range_count(self, name: str) -> int:
        return len(self.ranges.get(name, []))

    def under_ops(self, prefix: str) -> List[tuple]:
        """Device operations launched inside aten ops whose name starts
        with ``prefix``."""
        spans = [s for n, v in self.ops.items() if n.startswith(prefix)
                 for s in v]
        return self._inside(spans)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        inside the window summed by the innermost range the host's
        threads were in when each began."""
        by_name = defaultdict(float)
        for name, a, b, _, _ in self.device_ops:
            by_name[name] += (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        spans = sorted((a, b) for _, a, b, _, _ in self.device_ops)
        gaps, end = [], self.t0
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        named = [(n, a, b) for n, v in self.ranges.items() if n != WINDOW
                 for a, b, _ in v]
        by_gap = defaultdict(float)
        for a, b in gaps:
            inner = [(s, n) for n, s, e in named if s <= a < e]
            by_gap[max(inner)[1] if inner else 'host.other'] += \
                (b - a) / 1e6
        idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[n, s] for n, s in ops],
                'idle_gaps': [[n, s] for n, s in idle]}


def profile(run_window: Callable[[], None], device: torch.device
            ) -> TraceView:
    """Run ``run_window`` under the profiler (CPU and CUDA activities)
    inside the window range, and read the trace."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run_window()
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.unlink(path)
    return TraceView(events)
