"""CLI of the port: the turnkey accuracy-parity harness (counterpart of
``wsss_tpu/cli/parity.py``).

One command runs the full reference protocol through the port's command
lines — 01 classifier training, 02 Grad-CAM cue generation + cue eval,
03a SEC/DSRG, 03b IRNet, 03c HistoSegNet — over the published splits,
collects every mIoU, and diffs against the published tables
(``eval/baseline.py``) with a ±budget acceptance band.  ``--device``
(default the card) is forwarded to every stage; ``--mesh`` takes only
'none' until data-parallel training is ported (ROADMAP queue 1 item 8b),
since the reference forwards it to the training stages too.

With no devkit under --data_root it runs end-to-end on synthetic data
(smoke mode): every stage executes and the report is produced, but the
published diffs are informative only (exit code stays 0).

Numerics: the ±budget band is defended with the reference's end-to-end
float32 numerics, so --numerics defaults to f32: it clears
WSSS_TPU_BF16_INFER (and WSSS_TPU_NO_BF16_INFER) for every stage and keeps
the mean-field state in float32 (``meanfield._CRF_STATE_BF16 = False``).  --numerics bf16 turns both bf16 opt-ins on
(WSSS_TPU_BF16_INFER=1, ``_CRF_STATE_BF16 = True``), for measuring their
mIoU delta, not for certifying parity.  Both switches are restored when
``main`` returns.

    python -m wsss_tpu_torch.cli.parity --data_root /path/to/devkits \\
        --datasets VOC2012 --models vgg16

Outputs {eval_root}/parity_report.csv with one row per
(dataset, model, method, split): measured mIoU, published mIoU, delta,
within-budget flag.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import os
from typing import Dict, List, Optional

from wsss_tpu_torch.eval import baseline

ALL_DATASETS = ('VOC2012', 'ADP-morph', 'ADP-func', 'DeepGlobe',
                'DeepGlobe_balanced')

# published training splits (README.md:145-155, demo_tune.py:14-23)
TRAIN_SPLITS = {'VOC2012': 'train_aug', 'ADP-morph': 'train',
                'ADP-func': 'train', 'DeepGlobe': 'train75',
                'DeepGlobe_balanced': 'train37.5'}


def _base_args(a, dataset: str, model: str) -> List[str]:
    out = ['--dataset', dataset, '--model', model,
           '--batchsize', str(a.batchsize),
           '--synthetic_n', str(a.synthetic_n), '--device', a.device]
    if a.data_root:
        out += ['--data_root', a.data_root]
    if a.img_size:
        out += ['--img_size', str(a.img_size)]
    return out


def _train_split(a, dataset: str) -> str:
    return a.train_split or TRAIN_SPLITS[dataset]


def _eval_splits(a, dataset: str):
    return ((a.eval_split,) if a.eval_split
            else baseline.eval_splits(dataset))


def run_combo(a, dataset: str, model: str) -> List[dict]:
    """All five methods for one (dataset, model); returns report rows."""
    from wsss_tpu_torch.cli import (gen_cues, hsn, irn, sec_dsrg,
                                    train_classifier)
    base = _base_args(a, dataset, model)
    train_split = _train_split(a, dataset)
    rows: List[dict] = []

    def add(method: str, split: str, miou: Optional[float]):
        if miou is None:
            return
        pub = baseline.published_miou(dataset, split, model, method)
        delta = None if pub is None else miou - pub
        rows.append({'dataset': dataset, 'model': model,
                     'method': method, 'split': split,
                     'miou': round(miou, 5), 'published': pub,
                     'delta': None if delta is None else round(delta, 5),
                     'ok': (None if delta is None
                            else abs(delta) <= a.budget)})

    # --- 01: classifier -------------------------------------------------
    if not a.skip_train:
        train_classifier.main(base + [
            '--epochs', str(a.clf_epochs),
            '--train_split', train_split,
            '--val_split', _eval_splits(a, dataset)[0]])

    # --- 02: cues (train split for downstream, eval splits for the
    # published Grad-CAM column) ----------------------------------------
    gen_cues.main(base + ['--task', 'gen', '--split', train_split])
    is_adp = dataset.startswith('ADP')
    for split in _eval_splits(a, dataset):
        r = gen_cues.main(base + ['--task', 'eval', '--split', split]
                          + (['--set_name', split] if is_adp else []))
        if is_adp:
            htt = dataset.split('-')[-1]
            add('Grad-CAM', split, r.get(f'cue_miou_{htt}'))
        else:
            add('Grad-CAM', split, r.get('cue_miou'))

    # cue pickle path for 03a (02_cues on-disk contract)
    sid = dataset + '_' + model
    if is_adp:
        cues_pickle = os.path.join('cues', sid,
                                   dataset.split('-')[-1],
                                   'localization_cues.pickle')
    else:
        cues_pickle = os.path.join('cues', sid,
                                   'localization_cues.pickle')
    cue_args = (['--cues_pickle', cues_pickle]
                if os.path.exists(cues_pickle) else [])

    # --- 03a: SEC / DSRG ------------------------------------------------
    for method in ('SEC', 'DSRG'):
        if method.lower() in a.skip_methods:
            continue
        sec_dsrg.main(base + ['--task', 'train', '--method', method,
                              '--epochs', str(a.wsss_epochs),
                              '--train_split', train_split,
                              '--val_every', '0'] + cue_args)
        for split in _eval_splits(a, dataset):
            r = sec_dsrg.main(base + ['--task', 'predict',
                                      '--method', method,
                                      '--eval_split', split] + cue_args)
            add(method, split, r.get('miou'))

    # --- 03b: IRNet -----------------------------------------------------
    if 'irnet' not in a.skip_methods:
        irn_kw = ['--irn_epochs', str(a.wsss_epochs),
                  '--scales', a.scales]
        irn.main(base + irn_kw + ['--train_split', train_split,
                                  '--passes',
                                  'make_cam,cam_to_ir_label,train_irn'])
        for split in _eval_splits(a, dataset):
            # make_cam must re-run over the EVAL split before the walk
            # (demo_tune.py:63-66 calls func_sample with the val split)
            r = irn.main(base + irn_kw + [
                '--train_split', split, '--infer_split', split,
                '--passes', 'make_cam,make_sem_seg,eval_sem_seg'])
            add('IRNet', split, r.get('miou'))

    # --- 03c: HistoSegNet -----------------------------------------------
    if 'histosegnet' not in a.skip_methods:
        for split in _eval_splits(a, dataset):
            r = hsn.main(base + ['--split', split]
                         + (['--set_name', split] if is_adp else []))
            if is_adp:
                htt = dataset.split('-')[-1]
                add('HistoSegNet', split, r.get(f'miou_{htt}'))
            else:
                add('HistoSegNet', split, r.get('miou'))
    return rows


def write_report(path: str, rows: List[dict]) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    cols = ['dataset', 'model', 'method', 'split', 'miou', 'published',
            'delta', 'ok']
    with open(path, 'w', newline='') as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--data_root', default=None,
                   help='devkit root; synthetic smoke mode when absent')
    p.add_argument('--datasets', default='all',
                   help=f'comma list from {ALL_DATASETS} or "all"')
    p.add_argument('--models', default='both',
                   choices=['vgg16', 'alt', 'both'],
                   help='classifier seed families: VGG16 and/or the '
                        'per-dataset alternative (X1.7 for ADP, M7 '
                        'otherwise; README.md:147)')
    p.add_argument('--budget', type=float, default=0.005,
                   help='mIoU acceptance band vs the published number '
                        '(±0.5 pt, BASELINE.md)')
    p.add_argument('--batchsize', type=int, default=8)
    p.add_argument('--img_size', type=int, default=0)
    p.add_argument('--synthetic_n', type=int, default=16)
    p.add_argument('--clf_epochs', type=int, default=80,
                   help='01_train epochs (reference: 80 VOC / 100 DG)')
    p.add_argument('--wsss_epochs', type=int, default=0,
                   help='03a/03b epochs (0 = per-dataset sweep default)')
    p.add_argument('--scales', default='1.0,0.5,1.5,2.0')
    p.add_argument('--train_split', default=None,
                   help='override the published train split')
    p.add_argument('--eval_split', default=None,
                   help='override the published eval split(s)')
    p.add_argument('--skip_train', action='store_true',
                   help='reuse existing classifier checkpoints')
    p.add_argument('--skip_methods', default='',
                   help='comma list from sec,dsrg,irnet,histosegnet')
    p.add_argument('--mesh', default='none', choices=['none'],
                   help="device mesh: only 'none' (one device) until "
                        "data-parallel training is ported, as the "
                        "reference forwards --mesh to its training "
                        "stages too")
    p.add_argument('--device', default='cuda',
                   help="torch device forwarded to every stage: 'cuda' "
                        "(default; raises without a card) or 'cpu'")
    p.add_argument('--numerics', default='f32',
                   choices=['f32', 'bf16'],
                   help='f32 (default): pin the reference\'s end-to-end '
                        'float32 numerics for every stage — the budget '
                        'is defended with these.  bf16: the two bf16 '
                        'opt-ins (inference + CRF state), for measuring '
                        'their mIoU delta.')
    p.add_argument('--eval_root', default='eval')
    p.add_argument('--verbose', action='store_true')
    a = p.parse_args(argv)
    with numerics(a.numerics):
        return _run(a)


@contextlib.contextmanager
def numerics(mode: str):
    """The bf16 switches for the block: the environment that
    ``infer_dtype()`` reads when a handle is built, and the meanfield
    module flag read at call time; restored on exit."""
    from wsss_tpu_torch.ops.crf import meanfield
    names = ('WSSS_TPU_BF16_INFER', 'WSSS_TPU_NO_BF16_INFER')
    saved = {k: os.environ.get(k) for k in names}
    saved_state = meanfield._CRF_STATE_BF16
    for k in names:
        os.environ.pop(k, None)
    if mode == 'bf16':
        os.environ['WSSS_TPU_BF16_INFER'] = '1'
    meanfield._CRF_STATE_BF16 = mode == 'bf16'
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        meanfield._CRF_STATE_BF16 = saved_state


def _run(a) -> List[dict]:
    a.skip_methods = set(filter(None, a.skip_methods.lower().split(',')))
    if a.wsss_epochs == 0:
        a.wsss_epochs = 1 if not a.data_root else 0  # smoke: 1 epoch
    datasets = (ALL_DATASETS if a.datasets == 'all'
                else tuple(a.datasets.split(',')))

    rows: List[dict] = []
    for ds in datasets:
        models = {'vgg16': ('VGG16',),
                  'alt': (baseline.alt_model(ds),),
                  'both': ('VGG16', baseline.alt_model(ds))}[a.models]
        for model in models:
            print(f'=== parity: {ds} / {model} ===')
            rows += run_combo(a, ds, model)

    path = os.path.join(a.eval_root, 'parity_report.csv')
    write_report(path, rows)
    print(f'\n{"dataset":20s} {"model":6s} {"method":12s} {"split":10s} '
          f'{"miou":>8s} {"published":>9s} {"delta":>8s} ok')
    for r in rows:
        pub = '-' if r['published'] is None else f"{r['published']:.5f}"
        dlt = '-' if r['delta'] is None else f"{r['delta']:+.5f}"
        ok = '-' if r['ok'] is None else ('yes' if r['ok'] else 'NO')
        print(f"{r['dataset']:20s} {r['model']:6s} {r['method']:12s} "
              f"{r['split']:10s} {r['miou']:8.5f} {pub:>9s} {dlt:>8s} "
              f"{ok}")
    print(f'\nreport -> {path}')
    if a.data_root:
        bad = [r for r in rows if r['ok'] is False]
        if bad:
            raise SystemExit(
                f'{len(bad)} result(s) outside the ±{a.budget} budget')
    else:
        print('(synthetic smoke mode: published diffs are informative '
              'only)')
    return rows


if __name__ == '__main__':
    main()
