"""CLI of the port: 03a — SEC / DSRG training and prediction
(counterpart of ``wsss_tpu/cli/sec_dsrg.py``).  Runs on ``--device``
(default the card); on synthetic data when no devkit is given:

    python -m wsss_tpu_torch.cli.sec_dsrg --task train --method SEC
    python -m wsss_tpu_torch.cli.sec_dsrg --task predict --method SEC

Both tasks start from the latest checkpoint under
``--wsss_model_root/<run id>`` where there is one (the weights and, for
training, the optimizer's state), else from random weights or
``--init_npy``.

train: the DeepLab FCN learns from the cue pickle (or, without one,
synthetic cues from the downsampled ground truth) with the CRF layer
(+ region growing for DSRG) inside the step; val mIoU of the raw FCN
every ``--val_every`` steps; the losses go to
``log/<run id>/train.jsonl``, a checkpoint to the run's directory at
each epoch's end.

predict: FCN forward -> upscale -> test-time dense CRF -> argmax, one
image at its native size at a time, then the split's IoU csv + xlsx, the
confusion heatmap and, asked for, colorized predictions with overlays.
Reference semantics (03a model.py:684-696): for every dataset but
DeepGlobe the softmax score map AND the original image are resized to
the ground truth's resolution and the test CRF runs there; for DeepGlobe
the CRF runs at network resolution and only the argmax is resized.
"""
from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np
import torch

from wsss_tpu_torch.cli import common
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.data.pipeline import prefetch
from wsss_tpu_torch.eval import metrics, reports
from wsss_tpu_torch.io import artifacts, checkpoint
from wsss_tpu_torch.methods.gradcam_cues import _normalizer
from wsss_tpu_torch.ops.crf import config as crf_config
from wsss_tpu_torch.ops.crf.meanfield import mean_field
from wsss_tpu_torch.ops.filters import resize_bilinear, resize_nearest
from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor, SECDSRGTrainer
from wsss_tpu_torch.utils.timing import MetricsLogger, profile_trace, span

SEED_SIZE = 41  # 03a model.py:35

# Per-dataset defaults of the reference's sweep (03a_sec-dsrg/demo.py:
# 51-72): (cue threshold, epochs).
SWEEP_DEFAULTS = {
    ('ADP-morph', 'SEC'): (0.9, 8), ('ADP-morph', 'DSRG'): (0.9, 8),
    ('ADP-func', 'SEC'): (0.9, 8), ('ADP-func', 'DSRG'): (0.9, 8),
    ('VOC2012', 'SEC'): (0.2, 16), ('VOC2012', 'DSRG'): (0.2, 6),
    ('DeepGlobe', 'SEC'): (0.3, 100), ('DeepGlobe', 'DSRG'): (0.3, 100),
    ('DeepGlobe_balanced', 'SEC'): (0.4, 100),
    ('DeepGlobe_balanced', 'DSRG'): (0.4, 100),
}


def predict_crf_config(dataset: str, method: str) -> crf_config.CRFConfig:
    """The test-time CRF of a dataset and method (SEC.py:18-30,
    DSRG.py:77-78)."""
    if method.upper() == 'SEC':
        return crf_config.SEC_TEST.get(dataset, crf_config.DSRG_TEST)
    return crf_config.DSRG_TEST


def predict_image(predictor: SECDSRGPredictor, spec: registry.DatasetSpec,
                  method: str, native, out_hw: Tuple[int, int],
                  size: int = 321, ref_round: bool = False) -> torch.Tensor:
    """Labels [out_h, out_w] int32 (on the predictor's device) of one
    RGB image ``native`` [H, W, 3] 0..255 (uint8 or float, numpy or a
    tensor) — the loop body of the reference's predict task
    (cli/sec_dsrg.py:214-249).  ``ref_round`` is the CRF's CPU-test
    switch (``mean_field``)."""
    with span('wsss.sec.predict_image'):
        dev = predictor.device
        out_hw = (int(out_hw[0]), int(out_hw[1]))
        cfg = predict_crf_config(spec.name, method)
        with span('wsss.io.to_device'):
            native = torch.as_tensor(native).to(dev, torch.float32)
        net_in = resize_bilinear(native, (size, size))
        norm = _normalizer(spec.norm_sec, dev)
        logits = predictor.predict_logits(norm(net_in[None]))
        probs = torch.softmax(resize_bilinear(logits, (size, size)), dim=-1)
        if 'DeepGlobe' not in spec.name:
            # score map and image to GT resolution, CRF there
            probs = torch.clamp(resize_bilinear(probs, out_hw), 1e-8, 1.0)
            probs = probs / probs.sum(-1, keepdim=True)
            guide = (native if tuple(native.shape[:2]) == out_hw
                     else resize_bilinear(native, out_hw))
            q = mean_field(probs, guide[None], cfg, ref_round=ref_round)
            return torch.argmax(q, dim=-1)[0].to(torch.int32)
        q = mean_field(probs, net_in[None], cfg, ref_round=ref_round)
        pred = torch.argmax(q, dim=-1)[0]
        if tuple(pred.shape) != out_hw:
            pred = resize_nearest(pred.to(torch.float32)[..., None],
                                  out_hw)[..., 0]
        return pred.to(torch.int32)


def _load_cues(path):
    if path and os.path.exists(path):
        return artifacts.read_cue_pickle(path)
    return None


def _batch_cues(cue_dict, indices, n_cls, grid=SEED_SIZE):
    """Unpack pickle cues (41x41 contract) and nearest-resize them to the
    FCN grid when training at a non-reference input size; tags from the
    pickle's '{i}_labels' with the background always set."""
    dense, labels = [], []
    for i in indices:
        cue = (artifacts.unpack_cues(
            cue_dict, int(i), (SEED_SIZE, SEED_SIZE, n_cls))
            if cue_dict else np.zeros((SEED_SIZE, SEED_SIZE, n_cls),
                                      np.float32))
        if grid != SEED_SIZE:
            cue = resize_nearest(torch.from_numpy(cue), (grid, grid)).numpy()
        dense.append(cue)
        lab = np.zeros((n_cls,), np.float32)
        lab[0] = 1.0  # bg always tagged (model.py:244-246 semantics)
        if cue_dict is not None:
            lab[np.asarray(cue_dict.get(f'{int(i)}_labels', []),
                           np.int64)] = 1.0
        labels.append(lab)
    return np.stack(dense), np.stack(labels)


def _synthetic_cues(gt, n_cls, grid, step):
    """The fallback without a cue pickle: one-hot cues from the ground
    truth nearest-resized to the FCN grid, 10% of the pixels kept, drawn
    from ``np.random.default_rng(step)``; tags from the resized truth."""
    gt_s = resize_nearest(
        torch.as_tensor(gt, dtype=torch.float32)[..., None],
        (grid, grid))[..., 0].numpy().astype(np.int64)
    cues = np.eye(n_cls, dtype=np.float32)[np.clip(gt_s, 0, n_cls - 1)]
    cues *= (np.random.default_rng(step)
             .random(cues.shape[:3] + (1,)) < 0.1)
    labels = np.zeros((gt.shape[0], n_cls), np.float32)
    labels[:, 0] = 1
    for i in range(gt.shape[0]):
        labels[i][np.unique(gt_s[i])] = 1
    return cues, labels


def train(args, trainer: SECDSRGTrainer, spec, run_id: str, size: int,
          ckpt_root: str, mesh=None) -> None:
    """The train task's loop (03a model.py train): per-epoch shuffle, the
    ragged tail dropped, a checkpoint at each epoch's end.  With ``mesh``
    each step runs over its 'data' shards; the checkpoints come from
    shard 0's replica, the val mIoU runs unsharded."""
    dev = trainer.device
    n_cls = trainer.num_classes
    norm = _normalizer(spec.norm_sec, dev)
    logger = MetricsLogger(os.path.join('log', run_id, 'train.jsonl'))

    def val_miou():
        """Periodic raw-FCN val mIoU (03a model.py:505-531)."""
        vds, _ = common.get_batches(args, args.eval_split, size,
                                    with_gt=True)
        conf = np.zeros((n_cls, n_cls), np.int64)
        for vb in vds.batches(args.batchsize, with_gt=True):
            if vb.gt is None:
                continue
            imgs = torch.as_tensor(vb.images).to(dev, torch.float32)
            logits = trainer.predict_logits(norm(imgs))
            pred = torch.argmax(resize_bilinear(logits, vb.gt.shape[1:]),
                                dim=-1)
            conf = metrics.accumulate_confusion(
                conf, pred, torch.as_tensor(vb.gt, device=dev), n_cls)
        return float(metrics.iou_from_confusion(conf)[1])

    cue_dict = _load_cues(args.cues_pickle)
    ds, _ = common.get_batches(args, args.train_split, size)
    grid = (size - 1) // 8 + 1  # FCN stride-8 SAME grid
    step = 0
    with profile_trace(args.profile_dir):
        for epoch in range(args.epochs):
            # per-epoch shuffle (03a model.py:279 tf.data .shuffle) with a
            # prefetch thread overlapping decode with the train step
            for b in prefetch(ds.batches(args.batchsize,
                                         with_gt=cue_dict is None,
                                         shuffle=True)):
                if b.images.shape[0] != args.batchsize:
                    continue
                if cue_dict is not None:
                    cues, labels = _batch_cues(cue_dict, b.indices, n_cls,
                                               grid)
                else:
                    cues, labels = _synthetic_cues(b.gt, n_cls, grid, step)
                with span('wsss.io.to_device'):
                    imgs = torch.as_tensor(b.images).to(dev, torch.float32)
                parts = trainer.train_step(
                    norm(imgs), imgs, cues, labels,
                    torch.Generator(dev).manual_seed(step), mesh=mesh)
                step += 1
                logger.log(step, **{k: float(v) for k, v in parts.items()})
                if args.verbose:
                    msg = ' '.join(f'{k}={float(v):.4f}'
                                   for k, v in parts.items())
                    print(f'epoch {epoch} step {step} {msg}')
                if args.val_every and step % args.val_every == 0:
                    miou = val_miou()
                    logger.log(step, val_miou=miou)
                    print(f'step {step} val miou {miou:.5f}')
            checkpoint.save_checkpoint(ckpt_root, step,
                                       trainer.state_dict())
    print(f'trained {run_id} for {step} steps')


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_args(p)
    p.add_argument('--task', default='train',
                   choices=['train', 'predict'])
    p.add_argument('--method', default='SEC', choices=['SEC', 'DSRG'])
    p.add_argument('--epochs', type=int, default=0,
                   help='0 = the reference sweep default for the '
                        'dataset/method (03a demo.py:51-72)')
    p.add_argument('--threshold', type=float, default=None,
                   help='cue threshold recorded in the run id (naming '
                        'parity with 03a; cues are pre-thresholded)')
    p.add_argument('--lr', type=float, default=1e-4)
    p.add_argument('--accum_num', type=int, default=1)
    p.add_argument('--init_npy', default=None,
                   help="reference DeepLab init weights (SEC init.npy / "
                        "DSRG vgg16_deeplab_aspp.npy, 03a model.py:78-81)")
    p.add_argument('--cues_pickle', default=None,
                   help='localization_cues.pickle from 02_cues; synthetic '
                        'cues from tags when absent')
    p.add_argument('--train_split', default='train')
    p.add_argument('--eval_split', default='val')
    p.add_argument('--saveimg', action='store_true')
    p.add_argument('--wsss_model_root', default='models_wsss')
    p.add_argument('--val_every', type=int, default=200,
                   help='steps between val mIoU evals during training '
                        '(03a model.py:505-531; 0 = off)')
    p.add_argument('--profile_dir', default=None,
                   help='profiler trace output dir')
    args = p.parse_args(argv)
    mesh = common.dp_train_putters(args) if args.task == 'train' else None

    spec = registry.get(args.dataset)
    n_cls = spec.n_seg_classes
    size = 321 if not args.img_size else args.img_size  # model.py:34
    sweep = SWEEP_DEFAULTS.get((args.dataset, args.method), (0.2, 8))
    if not args.epochs:
        args.epochs = sweep[1]
    if args.threshold is None:
        args.threshold = sweep[0]
    run_id = f'{args.method}_{args.dataset}_{args.model}'
    if args.threshold != sweep[0]:   # 02_cues naming quirk parity
        run_id += f'_{args.threshold}'
    ckpt_root = os.path.join(args.wsss_model_root, run_id)

    if args.task == 'train':
        trainer = SECDSRGTrainer(args.method, n_cls,
                                 base_lr=args.lr, accum_num=args.accum_num,
                                 device=args.device)
        trainer.init(torch.Generator().manual_seed(0))
        net = trainer.net
    else:
        predictor = SECDSRGPredictor.random(args.method, n_cls, seed=0,
                                            device=args.device)
        net = predictor.net
    if args.init_npy:
        from wsss_tpu_torch.io.flax_bridge import (deeplab_params,
                                                   load_flax_deeplab)
        from wsss_tpu_torch.io.legacy import load_deeplab_init_npy
        load_flax_deeplab(net, load_deeplab_init_npy(
            args.init_npy, deeplab_params(net)))
        print(f'initialized trunk+head from {args.init_npy}')
    if checkpoint.latest_step(ckpt_root) is not None:
        state, st = checkpoint.restore_checkpoint(
            ckpt_root, map_location=next(net.parameters()).device)
        if args.task == 'train':
            trainer.load_state_dict(state)
        else:
            net.load_state_dict(state['params'])
        print(f'resumed {run_id} from step {st}')
    if args.task == 'train':
        train(args, trainer, spec, run_id, size, ckpt_root, mesh)
        return

    # --- predict: FCN forward -> upscale -> test-time CRF -> eval ------
    ds, _ = common.get_batches(args, args.eval_split, size, with_gt=True)
    conf = np.zeros((n_cls, n_cls), np.int64)
    out_dir = os.path.join(args.out_root, run_id)
    for b in prefetch(ds.iter_native(with_gt=True)):
        native = b.images[0]
        gt = b.gt[0] if b.gt is not None else None
        out_hw = gt.shape if gt is not None else native.shape[:2]
        pred = predict_image(predictor, spec, args.method, native, out_hw,
                             size=size)
        if gt is not None:
            conf = metrics.accumulate_confusion(
                conf, pred, torch.as_tensor(gt, device=pred.device), n_cls)
        if args.saveimg:
            # colorized pred + overlay on the original (model.py:588-612)
            reports.save_color_and_overlay(
                out_dir, b.names[0], pred.cpu().numpy(),
                spec.palette_array(), native, r=0.75)
    iou, miou = metrics.iou_from_confusion(conf)
    path = os.path.join(args.eval_root, run_id,
                        f'{args.eval_split}_iou.csv')
    reports.write_iou_csv(path, spec.seg_class_names, iou)
    reports.confusion_heatmap(
        os.path.join(args.eval_root, run_id, 'confusion.png'), conf,
        spec.seg_class_names)
    print(f'[{args.method}, {args.eval_split}] miou: {miou:.5f}')
    return {'miou': miou}


if __name__ == '__main__':
    main()
