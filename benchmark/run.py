#!/usr/bin/env python3
"""The benchmark of wsss_tpu_torch: one cell, one run, one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards; see
benchmark/README.md."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    from benchmark.harness.runner import main
    sys.exit(main())
