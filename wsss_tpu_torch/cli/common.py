"""Shared CLI plumbing of the port (counterpart of
``wsss_tpu/cli/common.py``): settings, session ids, model-handle loading
and batches.

Mirrors the reference's layered config (SURVEY.md §5.6): settings.ini for
roots (settings.ini:1-7), argparse per stage, and the dataclass registry
for everything per-dataset.  Two departures: ``--device`` (default
'cuda') picks the card or, asked for, the CPU; the training command lines
refuse a ``--mesh`` other than 'none' (``refuse_mesh``) until
data-parallel training is ported (ROADMAP queue 1 item 8b).
"""
from __future__ import annotations

import argparse
import configparser
import os
from typing import Optional

import numpy as np

from wsss_tpu_torch.data import registry
from wsss_tpu_torch.data.pipeline import open_dataset


def load_settings(path: str = 'settings.ini') -> dict:
    cfg = configparser.ConfigParser()
    out = {'data_dir': None, 'model_cnn_dir': 'models_cnn',
           'cues_dir': 'cues', 'model_wsss_dir': 'models_wsss'}
    if os.path.exists(path):
        cfg.read(path)
        for sec in cfg.sections():
            for k, v in cfg[sec].items():
                out[k] = v
    return out


def add_common_args(p: argparse.ArgumentParser):
    ini = load_settings()
    p.add_argument('--dataset', default='VOC2012',
                   choices=sorted(registry.REGISTRY))
    p.add_argument('--model', default='VGG16',
                   choices=['VGG16', 'VGG16fg', 'VGG16fg_bn', 'M1', 'M2',
                            'M3', 'M4', 'M5', 'M6', 'M7', 'X1.7'])
    p.add_argument('--batchsize', type=int, default=8)
    p.add_argument('--data_root', default=ini.get('data_dir'),
                   help='devkit root (settings.ini data_dir; falls back '
                        'to synthetic data)')
    p.add_argument('--out_root', default='out')
    p.add_argument('--eval_root', default='eval')
    p.add_argument('--model_root', default=ini.get('model_cnn_dir',
                                                   'models_cnn'))
    p.add_argument('--synthetic_n', type=int, default=16,
                   help='synthetic dataset size when no devkit exists')
    p.add_argument('--img_size', type=int, default=0,
                   help='override input size (0 = per-model default)')
    p.add_argument('--mesh', default='none',
                   help="device mesh for multi-device runs: 'none' "
                        "(single device), 'auto' (all visible devices of "
                        "--device's type), or an integer device count "
                        "(at most the visible ones).  Replaces the "
                        "reference's per-GPU process spawn "
                        "(make_cam.py:120-122, SURVEY.md §2.8) with one "
                        "process over a parallel.mesh.Mesh.  Training "
                        "takes only 'none' so far.")
    p.add_argument('--device', default='cuda',
                   help="torch device: 'cuda' (default; raises without a "
                        "card) or 'cpu'")
    p.add_argument('--verbose', action='store_true')
    return p


def get_mesh(args):
    """Resolve --mesh into a ``parallel.mesh.Mesh`` over --device's type
    (or None)."""
    v = getattr(args, 'mesh', 'none')
    if not v or v == 'none':
        return None
    from wsss_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(None if v == 'auto' else int(v),
                     device=getattr(args, 'device', 'cuda'))


def refuse_mesh(args, what: str) -> None:
    """Training runs on one device until the reference's data-parallel
    putters (``dp_train_putters``) are ported: refuse any other --mesh
    before anything is written."""
    v = getattr(args, 'mesh', 'none')
    if v and v != 'none':
        raise NotImplementedError(
            f'{what} with --mesh {v}: data-parallel training is not ported '
            'yet (ROADMAP queue 1 item 8b); pass --mesh none')


def input_size(args) -> int:
    if args.img_size:
        return args.img_size
    spec = registry.get(args.dataset)
    return (spec.clf_size_vgg16 if args.model.startswith('VGG')
            else spec.clf_size_m7)


def sess_id(args, set_name: Optional[str] = None) -> str:
    """'{dataset}_{model}' (+set) naming, 02_cues/demo.py:67-72."""
    parts = [args.dataset]
    if set_name:
        parts.append(set_name)
    parts.append(args.model)
    return '_'.join(parts)


def load_handle(args, num_classes: int, size: int, seed: int = 0,
                suffix: str = ''):
    """Classifier handle on ``args.device`` from a saved triplet, else
    random-init (synthetic smoke mode).  Built at ``infer_dtype()``; a
    triplet's model keeps flax's initial batch statistics, as in the
    reference."""
    from wsss_tpu_torch.io import checkpoint
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.models.backbones import (build_classifier,
                                                 infer_dtype)
    from wsss_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    sid = sess_id(args) + suffix
    model_dir = os.path.join(args.model_root, sid)
    npz = os.path.join(model_dir, sid + '.npz')
    if os.path.exists(npz):
        model = build_classifier(args.model + suffix.replace('bg', ''),
                                 num_classes, dtype=infer_dtype())
        _, model, thresholds = checkpoint.import_triplet(model_dir, sid,
                                                         model)
        if thresholds is None:
            thresholds = np.full((num_classes,), 0.5, np.float32)
        h = _ClassifierHandle(model, thresholds, size, device=device)
        if args.verbose:
            print(f'loaded {sid} from {model_dir}')
        return h
    if args.verbose:
        print(f'no saved model at {npz}; using random init')
    return _ClassifierHandle.random(args.model, num_classes, size,
                                    seed=seed, device=device)


def get_batches(args, split: str, size: int, with_gt: bool = False,
                htt: Optional[str] = None):
    ds = open_dataset(args.dataset, args.data_root, split, size,
                      synthetic_n=args.synthetic_n, htt=htt)
    return ds, ds.batches(args.batchsize, with_gt=with_gt)
