#!/usr/bin/env python3
"""The readings a cell's limits are set from (not run by the benchmark's
own runs).

    python3 benchmark/tools/readings.py --workload <cell> \
        --seeds 11,12,... [--control 11,12,13] [--half 11,12,13] \
        [--calls N]

For each seed of ``--seeds``: the cell's program at its own size, driven
through its entry for ``--calls`` calls (the traffic's ``check_calls``
kept from them), and its gaps to the float32 reference: the lower
readings.  For each seed of ``--control``: the reference in TF32 put in
the program's place, its gaps to the float32 reference: the upper
readings.  For ``--half`` (training cells): the reference on the first
half of each batch in the program's place (the half-batch fault).  One
JSON line a reading on stdout."""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def seeds(text):
    return [int(s) for s in text.split(',') if s]


def main():
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import runner, spec, trace

    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=seeds, default=[])
    p.add_argument('--control', type=seeds, default=[])
    p.add_argument('--half', type=seeds, default=[])
    p.add_argument('--repeat', type=seeds, default=[],
                   help='seeds whose calls the program runs twice: the '
                        'gaps of its second outputs to its first')
    p.add_argument('--calls', type=int, default=None)
    p.add_argument('--traffic', type=json.loads, default={},
                   help='JSON object of traffic keys to replace')
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell['config'])
    traffic = {**spec.traffic(cell['traffic']), **args.traffic}
    mod = spec.entry(traffic['entry'])
    dev = torch.device(args.device)

    for seed in dict.fromkeys(args.seeds + args.control + args.half
                              + args.repeat):
        t0 = time.perf_counter()
        with trace.Ranges(False) as ranges:
            entry = mod.Entry(cfg, traffic, seed, dev, ranges)
            calls = args.calls or traffic['check_calls']
            entry.keep(runner.sample_calls(seed, traffic, calls))
            for i in range(calls):
                entry.call(i, entry.inputs(i))
            first = dict(entry.program_outputs())
            if seed in args.repeat:
                entry.keep(runner.sample_calls(seed, traffic, calls))
                entry.kept = {}
                for i in range(calls):
                    entry.call(i, entry.inputs(i))
            runner.sync(dev)
        entry.release()
        ref = entry.reference_outputs('fp32')
        out = []
        if seed in args.repeat:
            out.append(('program_twice',
                        entry.gaps(entry.program_outputs(), first)))
        if seed in args.seeds:
            out.append(('program', entry.gaps(first, ref)))
        if seed in args.control:
            out.append(('control_tf32',
                        entry.gaps(entry.reference_outputs('tf32'), ref)))
        if seed in args.half:
            rows = traffic['batch'] // 2
            out.append(('fault_half_batch',
                        entry.gaps(entry.reference_outputs('fp32', rows),
                                   ref)))
        for kind, gaps in out:
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'kind': kind, 'gaps': gaps,
                              'seconds': time.perf_counter() - t0}),
                  flush=True)
        del entry, ref
        if dev.type == 'cuda':
            torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
