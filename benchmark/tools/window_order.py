#!/usr/bin/env python3
"""The reading below which a window cell's limits may not sit (not run by
the benchmark's own runs): the plain reference against itself with its
window's offsets summed in reverse order.

    python3 benchmark/tools/window_order.py --workload hsn_adp_b8 \
        --seeds 11,12,13 [--calls N]

A kernel that sums the offsets in another order than the reference is as
right as the reference, so a limit must hold this reading with room.
For each seed: the cell's program at its own size, driven through its
entry for ``--calls`` calls (the traffic's ``check_calls`` kept from
them), then the reference's outputs on the kept unaries twice, forwards
and backwards; one JSON line a seed with the gaps of the second to the
first."""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import runner, spec, trace

    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=lambda s: [int(x) for x in s.split(',')],
                   required=True)
    p.add_argument('--calls', type=int, default=None)
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell['config'])
    traffic = spec.traffic(cell['traffic'])
    mod = spec.entry(traffic['entry'])
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        with trace.Ranges(False) as ranges:
            entry = mod.Entry(cfg, traffic, seed, dev, ranges)
            calls = args.calls or traffic['check_calls']
            entry.keep(runner.sample_calls(seed, traffic, calls))
            for i in range(calls):
                entry.call(i, entry.inputs(i))
        entry.release()
        forwards = entry.reference_outputs('fp32')
        entry.reverse_window = True
        gaps = entry.gaps(entry.reference_outputs('fp32'), forwards)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'kind': 'reference_reversed', 'gaps': gaps,
                          'seconds': time.perf_counter() - t0}), flush=True)
        del entry, forwards
        if dev.type == 'cuda':
            torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
