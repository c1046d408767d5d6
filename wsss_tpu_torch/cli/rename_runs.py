"""CLI of the port: rename legacy DeepGlobe run directories/files to the
split-tag naming (a copy of ``wsss_tpu/cli/rename_runs.py``).

Port of `scripts/rename_pt.py` (the reference's one-off migration of
DSRG checkpoints from the `_train75_` / `_train37.5_` era to the
`DeepGlobe` / `DeepGlobe_balanced` naming): `_train75_` drops to `_`,
`_train37.5_` becomes `_balanced_`, applied to files then folders.

Usage: python -m wsss_tpu_torch.cli.rename_runs <dir> [--dry_run]
"""
from __future__ import annotations

import argparse
import os

_RULES = (('_train75_', '_'), ('_train37.5_', '_balanced_'))


def _renamed(name: str) -> str:
    for old, new in _RULES:
        if old in name:
            return name.replace(old, new)
    return name


def rename_runs(root: str, dry_run: bool = False) -> int:
    """Apply the rename rules to run files then their folders (the
    reference's order — files first so folder paths stay valid).
    Returns the number of renames."""
    n = 0
    folders = [x for x in os.listdir(root)
               if not os.path.isfile(os.path.join(root, x))]
    for folder in folders:
        fdir = os.path.join(root, folder)
        for fname in os.listdir(fdir):
            new = _renamed(fname)
            if new != fname:
                n += 1
                if not dry_run:
                    os.rename(os.path.join(fdir, fname),
                              os.path.join(fdir, new))
        new = _renamed(folder)
        if new != folder:
            n += 1
            if not dry_run:
                os.rename(fdir, os.path.join(root, new))
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('dir', help='runs directory (e.g. models_wsss/DSRG)')
    ap.add_argument('--dry_run', action='store_true')
    args = ap.parse_args(argv)
    n = rename_runs(args.dir, dry_run=args.dry_run)
    print(f'{"would rename" if args.dry_run else "renamed"} {n} entries')


if __name__ == '__main__':
    main()
