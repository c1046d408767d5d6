"""One run of one cell: set-up, the window, the trace, the check, and the
one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

``--trace 0`` times a closed loop of calls for ``--seconds`` and prints
the cell's end-to-end metrics; ``--trace 1`` runs the traffic file's
``trace_calls`` calls under ``torch.profiler`` and prints the cell's
per-layer metrics.  Both check the outputs of the timed path against the
plain reference once the window has closed and the peak memory has been
read, and print each number compared beside its limit (last on stderr,
and last in the result line under ``check``)."""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import guards, spec, trace
from benchmark.harness.traffic import sub_seed


def process_start_epoch() -> float:
    """Wall time at which this process started (Linux), else now."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        with open('/proc/stat') as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith('btime'))
        return btime + int(fields[19]) / os.sysconf('SC_CLK_TCK')
    except (OSError, StopIteration, ValueError, IndexError):
        return time.time()


def sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def sample_calls(seed: int, traffic: dict, calls: int) -> List[int]:
    """Call indices whose outputs the check compares, drawn from the
    seed among the first ``min(check_range, calls)`` calls."""
    n = min(traffic['check_range'], calls)
    k = min(traffic['check_calls'], n)
    rng = np.random.default_rng(sub_seed(seed, 'sample'))
    return sorted(int(i) for i in rng.choice(n, k, replace=False))


def p95(values: List[float]) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method='inclusive')[18]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'unknown'


def check(entry, limits: dict) -> List[Tuple[str, float, float]]:
    """(name, reading, limit) of each number compared: the timed path's
    outputs against the plain reference in float32."""
    got = entry.program_outputs()
    if not got:         # no sampled call came inside the window
        return [('outputs_kept', float('inf'), 0.0)]
    gaps = entry.gaps(got, entry.reference_outputs('fp32'))
    return [(k, gaps[k], limits[k]) for k in sorted(gaps)]


def run(bench: dict, workload: str, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, overrides: dict = None
        ) -> dict:
    """The result of one run (the printed line's object).  ``overrides``
    ({'config': {...}, 'traffic': {...}}) replaces keys of the cell's
    files: the CPU tests run the cells at a size the CPU holds."""
    overrides = overrides or {}
    cell = spec.cell(bench, workload)
    cfg = {**spec.config(bench, cell['config']),
           **overrides.get('config', {})}
    traffic = {**spec.traffic(cell['traffic']),
               **overrides.get('traffic', {})}
    mod = spec.entry(traffic['entry'])
    with trace.Ranges(traced) as ranges:
        entry = mod.Entry(cfg, traffic, seed, device, ranges)
        sync(device)
        setup_s = time.time() - t_start

        lat: List[float] = []
        done = {'calls': 0, 'images': 0}
        max_calls = traffic['trace_calls'] if traced else None
        entry.keep(sample_calls(seed, traffic, max_calls or
                                traffic['check_range']))

        def window():
            t_end = time.perf_counter() + seconds
            i = 0
            while (i < max_calls if traced else
                   time.perf_counter() < t_end):
                inp = entry.inputs(i)
                t0 = time.perf_counter()
                done['images'] += entry.call(i, inp)
                lat.append(time.perf_counter() - t0)
                i += 1
            done['calls'] = i

        view: Optional[trace.TraceView] = None
        ranges.counters.clear()
        t0 = time.perf_counter()
        if traced:
            view = trace.profile(window, device)
        else:
            window()
            sync(device)
        window_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == 'cuda' else 0)
    entry.release()
    checks = check(entry, traffic['limits'])
    correct = all(np.isfinite(v) and v <= lim for _, v, lim in checks)

    metrics = {}
    if not traced:
        rate, tail = done['images'] / window_s, 1e3 * p95(lat)
        values = {'img_per_s': rate, 'latency_p95_ms': tail,
                  'setup_s': setup_s}
        for m in spec.end_to_end_of(bench, workload):
            if m['name'] in values:
                metrics[m['name']] = {'value': values[m['name']],
                                      'unit': m['unit']}
    else:
        work = entry.work()
        run_info = {'calls': done['calls'], 'images': done['images'],
                    'latency_s': list(lat),
                    'counters': dict(ranges.counters), **work}
        for m in spec.per_layer_of(bench, workload):
            value = spec.metric(m['name']).read(view, run_info)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}

    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': (torch.cuda.get_device_name(device)
                    if device.type == 'cuda' else 'cpu'),
           'count': cell['chips'], 'memory_peak_bytes': int(peak)}
    result = {'correct': bool(correct), 'attempted': done['calls'],
              'failed': 0, 'metrics': metrics, 'device': dev}
    if view is not None:
        dev['busy_s'] = view.busy_s
        dev['window_s'] = view.window_s
        result['breakdown'] = view.breakdown()
    result['check'] = {n: {'value': v, 'limit': lim} for n, v, lim in checks}
    return result


def main(argv=None) -> int:
    t_start = process_start_epoch()
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    try:
        guards.require_cards(cell['chips'])
    except guards.Refused as e:
        print(f'refused: {e}', file=sys.stderr)
        return 2
    threads = spec.traffic(cell['traffic']).get('host_threads')
    if threads:
        # a closed loop of small launches: the host's share of each call
        # goes through the intra-op pool, whose threads wait on each
        # other when the host's cores are shared
        torch.set_num_threads(int(threads))
    result = run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace), torch.device('cuda', 0), t_start)
    found = guards.forbidden_loaded()
    if found:
        print(f'refused: loaded in this process: {", ".join(found)}',
              file=sys.stderr)
        return 3
    if args.trace:
        print(f'card: {power_limit()}', file=sys.stderr)
    for name, c in result['check'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
