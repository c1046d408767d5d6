"""CLI of the port: results aggregator (counterpart of
``wsss_tpu/cli/extract_eval.py``, scripts/extract_eval.py:1-100).

Walks the eval tree, collects every run's mIoU (the ``*_iou.csv`` files
and reference-layout ``.xlsx`` tables) and prints one table, through
pandas where it is installed:

    python -m wsss_tpu_torch.cli.extract_eval --eval_root eval
"""
from __future__ import annotations

import argparse

from wsss_tpu_torch.eval.reports import extract_eval


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--eval_root', default='eval')
    args = p.parse_args(argv)
    rows = extract_eval(args.eval_root)
    if not rows:
        print(f'no *_iou.csv results under {args.eval_root}')
        return
    try:
        import pandas as pd
    except ImportError:
        for r in rows:
            print(f'{r["run"]}: {r["miou"]}')
        return
    print(pd.DataFrame(rows).to_string(index=False))


if __name__ == '__main__':
    main()
