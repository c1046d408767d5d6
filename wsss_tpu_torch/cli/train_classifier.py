"""CLI of the port: 01_train — multi-label classifier training + ROC
calibration (counterpart of ``wsss_tpu/cli/train_classifier.py``).

Rebuilds 01_train/demo.py:21-235: train with BCE + SGD-Nesterov and a
cyclic or step LR (demo.py:60-110), then predict on the validation split,
calibrate per-class thresholds at the sensitivity=specificity ROC point
(demo.py:184-192, utilities.py:99-114), and export the model triplet
(.json/.npz/.mat and the Keras .h5 — demo.py:63-66,125-127,189-192).
Runs on ``--device`` (default the card); on synthetic data when no
devkit is given:

    python -m wsss_tpu_torch.cli.train_classifier --dataset VOC2012

Training checkpoints are ``torch.save`` files of the model's state dict
and the optimizer's state under ``--model_root/<sess id>/ckpt``;
``--resume`` continues from the latest one and ``--task predict``
calibrates from it without training.  ``--mesh auto`` (or N) trains
data-parallel over the mesh's 'data' shards, the batch's statistics,
loss and dropout masks the global batch's; the checkpoints come from
shard 0's replica, the calibration runs unsharded on shard 0's device.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from wsss_tpu_torch.cli import common
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.data.augment import classifier_augment
from wsss_tpu_torch.data.pipeline import prefetch
from wsss_tpu_torch.eval import metrics, reports
from wsss_tpu_torch.io import checkpoint
from wsss_tpu_torch.io.flax_bridge import classifier_variables
from wsss_tpu_torch.methods.gradcam_cues import _normalizer
from wsss_tpu_torch.models.backbones import build_classifier
from wsss_tpu_torch.train.classifier import ClassifierTrainer
from wsss_tpu_torch.utils.timing import profile_trace


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_args(p)
    p.add_argument('--task', default='train',
                   choices=['train', 'predict'],
                   help='predict = calibrate/evaluate from the latest '
                        'checkpoint without training (01_train/demo.py '
                        'predict(), :129-213)')
    p.add_argument('--epochs', type=int, default=1)
    p.add_argument('--lr', type=float, default=0.01)
    p.add_argument('--schedule', default='clr',
                   choices=['clr', 'step', 'const'])
    p.add_argument('--train_split', default='train')
    p.add_argument('--val_split', default='val')
    p.add_argument('--resume', action='store_true')
    p.add_argument('--no_class_wgt', action='store_true',
                   help='disable inverse-frequency class weighting '
                        '(reference should_wgt, 01_train/demo.py:80-82)')
    p.add_argument('--no_aug', action='store_true',
                   help='train without augmentation (the reference trains '
                        'with the per-dataset datagen_aug config, '
                        '02_cues/dataset.py:32-96; val always un-augmented)')
    p.add_argument('--profile_dir', default=None,
                   help='write a torch.profiler trace of the train steps '
                        'here')
    args = p.parse_args(argv)
    mesh = common.dp_train_putters(args)

    spec = registry.get(args.dataset)
    size = common.input_size(args)
    ds, _ = common.get_batches(args, args.train_split, size)
    n_cls = spec.n_fg_classes
    fg_names = spec.fg_class_names
    tag_map = None
    if args.dataset.startswith('ADP'):
        # The ADP classifier is the JOINT 31-way HistoNet (51 for X1.7)
        # trained over all HTTs at once (01_train/demo.py:21 with the
        # ADP taxonomy, 02_cues/adp_cues.py:43-50) — not the per-HTT fg
        # set.  Devkit CSVs already carry full-width tags; narrower tag
        # sources (synthetic) are scattered into the joint space.
        full = (registry.ADP_CLASSES_X17 if args.model == 'X1.7'
                else registry.ADP_CLASSES_VGG16)
        n_cls, fg_names = len(full), full
        if ds.split_tags().shape[1] != n_cls:
            tag_map = np.array([full.index(c) if c in full else -1
                                for c in spec.fg_class_names])

    def expand_tags(t):
        if tag_map is None:
            return np.asarray(t, np.float32)
        out = np.zeros((t.shape[0], n_cls), np.float32)
        valid = tag_map >= 0
        out[:, tag_map[valid]] = np.asarray(t)[:, valid]
        return out

    model = build_classifier(args.model, n_cls)
    # inverse-frequency class weighting (01_train/demo.py:80: n /
    # pos_count), the count floored at 1 as the reference's CLI does
    class_weights = None
    if not args.no_class_wgt:
        tags_all = expand_tags(ds.split_tags())
        class_weights = len(ds) / np.maximum(np.sum(tags_all, axis=0), 1.0)
    trainer = ClassifierTrainer(model, lr=args.lr, schedule=args.schedule,
                                class_weights=class_weights,
                                device=args.device)
    trainer.init(torch.Generator().manual_seed(0))
    dev = trainer.device
    norm = _normalizer(spec.norm_cues, dev)

    def to_dev(x):
        return torch.as_tensor(x).to(dev, torch.float32)

    sid = common.sess_id(args)
    ckpt_root = os.path.join(args.model_root, sid, 'ckpt')
    start_step = 0
    if ((args.resume or args.task == 'predict')
            and checkpoint.latest_step(ckpt_root) is not None):
        state, start_step = checkpoint.restore_checkpoint(
            ckpt_root, map_location=dev)
        if args.task == 'predict':
            # the weights only: the optimizer's state is irrelevant here
            trainer.model.load_state_dict(state['params'])
        else:
            trainer.load_state_dict(state)
        print(f'resumed from step {start_step}')

    step = start_step
    aug = None if args.no_aug else classifier_augment(args.dataset)
    with profile_trace(args.profile_dir):
        for epoch in range(args.epochs if args.task == 'train' else 0):
            # per-epoch shuffle + host augmentation, decoded ahead of the
            # device step by the prefetch thread
            for b in prefetch(ds.batches(args.batchsize, shuffle=True,
                                         augment=aug)):
                if b.images.shape[0] != args.batchsize:
                    continue  # the reference drops the ragged tail
                m = trainer.train_step(
                    norm(to_dev(b.images)), to_dev(expand_tags(b.tags)),
                    torch.Generator(dev).manual_seed(step), mesh=mesh)
                step += 1
                if args.verbose:
                    print(f'epoch {epoch} step {step} '
                          f'loss {float(m["loss"]):.4f} '
                          f'f1 {float(m["f1"]):.4f}')
            checkpoint.save_checkpoint(ckpt_root, step,
                                       trainer.state_dict())

    # --- calibrate thresholds on the validation split ------------------
    val_ds, _ = common.get_batches(args, args.val_split, size)
    scores_all, tags_all = [], []
    for b in val_ds.batches(args.batchsize):
        sc = trainer.eval_scores(norm(to_dev(b.images)))
        scores_all.append(sc.cpu().numpy())
        tags_all.append(expand_tags(b.tags))
    scores = np.concatenate(scores_all)
    tags = np.concatenate(tags_all)
    thresholds = np.asarray(metrics.optimal_thresholds(tags, scores))
    m = metrics.thresholded_metrics(tags, scores, thresholds)
    eval_dir = os.path.join(args.eval_root, sid)
    reports.write_metrics_csv(os.path.join(eval_dir, sid + '_metrics.csv'),
                              fg_names, m)
    reports.plot_rocs(os.path.join(eval_dir, sid + '_ROC.png'),
                      tags, scores, fg_names)

    out_dir = os.path.join(args.model_root, sid)
    checkpoint.export_triplet(
        out_dir, sid,
        arch={'model': args.model, 'num_classes': n_cls, 'input': size,
              'dataset': args.dataset},
        model=trainer.model, thresholds=thresholds,
        # the full variables -> also a Keras-2.2.4-layout .h5, so the
        # reference's own loaders can read the trained weights
        # (01_train/demo.py:63-66 artifact contract, two-way)
        variables=classifier_variables(trainer.model))
    print(f'exported triplet to {out_dir}; '
          f'mean val F1 {np.nanmean(m["f1"]):.4f}')
    return {'sid': sid, 'mean_f1': float(np.nanmean(m['f1']))}


if __name__ == '__main__':
    main()
