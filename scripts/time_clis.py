#!/usr/bin/env python3
"""Time the port's command lines as a user runs them: each in a new
process, on the card by default, in a temporary working directory (so
synthetic data and random weights), wall clock with the start-up.

    python3 scripts/time_clis.py

Prints one line per command (its wall seconds and exit code) after the
card's name and power limit, and a JSON line of all of them last.  The
training commands come first (1 epoch each), so the SEC prediction
restores the SEC checkpoint they wrote; ``cli.irn`` runs all six passes
(``--passes all``, the default: 16 images, two train_irn steps at batch
8, no checkpoint written beforehand); ``cli.parity`` runs last in its
synthetic smoke mode on the classifier triplet trained first
(``--skip_train``), without 03a: on a machine without matplotlib 01's ROC
plot and 03a's confusion heatmap stop a new process (``chip_smoke.py``'s
parity phase runs the whole chain in-process with stand-ins for them).
Exits non-zero if any command fails.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMANDS = [
    ('train_classifier VOC2012', ['train_classifier', '--dataset',
                                  'VOC2012', '--epochs', '1']),
    ('sec_dsrg train SEC', ['sec_dsrg', '--task', 'train', '--method',
                            'SEC', '--epochs', '1']),
    ('sec_dsrg train DSRG', ['sec_dsrg', '--task', 'train', '--method',
                             'DSRG', '--epochs', '1']),
    ('gen_cues VOC2012', ['gen_cues', '--dataset', 'VOC2012',
                          '--task', 'eval']),
    ('gen_cues ADP X1.7', ['gen_cues', '--dataset', 'ADP-morph',
                           '--model', 'X1.7', '--task', 'eval']),
    ('hsn VOC2012', ['hsn', '--dataset', 'VOC2012', '--saveimg']),
    ('hsn ADP X1.7', ['hsn', '--dataset', 'ADP-morph', '--model', 'X1.7',
                      '--saveimg']),
    ('sec_dsrg predict SEC', ['sec_dsrg', '--task', 'predict', '--method',
                              'SEC', '--saveimg']),
    ('irn VOC2012 --passes all', ['irn', '--dataset', 'VOC2012',
                                  '--model', 'VGG16']),
    ('extract_eval', ['extract_eval']),
    ('rename_runs --dry_run', ['rename_runs', 'eval', '--dry_run']),
    ('parity VOC2012 smoke', ['parity', '--datasets', 'VOC2012',
                              '--models', 'vgg16', '--skip_train',
                              '--skip_methods', 'sec,dsrg']),
]


def main():
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip() or f'nvidia-smi: {smi.stderr.strip()}')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    times, failed = {}, False
    with tempfile.TemporaryDirectory() as cwd:
        for label, cmd in COMMANDS:
            argv = [sys.executable, '-m', f'wsss_tpu_torch.cli.{cmd[0]}']
            t0 = time.perf_counter()
            res = subprocess.run(argv + cmd[1:], cwd=cwd, env=env,
                                 capture_output=True, text=True, timeout=600)
            dt = time.perf_counter() - t0
            tail = (res.stdout + res.stderr).strip().splitlines()[-3:]
            print(f'[{label}] {dt:.2f} s wall, exit {res.returncode}: '
                  + ' / '.join(tail))
            times[label] = round(dt, 2)
            failed |= res.returncode != 0
    print(json.dumps({'wall_s': times}))
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
