"""CLI of the port: 03b — IRNet's inference passes (counterpart of
``wsss_tpu/cli/irn.py``): make_cam -> eval_cam -> cam_to_ir_label ->
make_sem_seg -> eval_sem_seg.  Runs on ``--device`` (default the card); on
synthetic data when no devkit is given, with a random classifier unless
``--model_root`` holds its triplet:

    python -m wsss_tpu_torch.cli.irn --dataset VOC2012 --model VGG16 \\
        --passes make_cam,eval_cam,cam_to_ir_label,make_sem_seg,eval_sem_seg

Intermediate artifacts keep the reference's on-disk contract (.npy cam
dicts, ir-label PNGs) under ``--work_root/IRN_<dataset>_<model>``.
make_sem_seg restores the IRNet from the latest checkpoint under the
run's ``irn_ckpt`` directory: a ``torch.save`` file of ``{'variables':
IRNet.state_dict(), 'disp_mean': tensor [2]}`` (``io.checkpoint``; an
orbax checkpoint of the JAX package does not load), and raises
FileNotFoundError without one.  IRNet training (the ``train_irn`` pass,
which ``--passes all`` includes, and ``--tune``, which trains) is not
ported yet: asking for it raises NotImplementedError before any pass runs
(ROADMAP queue 1 item 6b); the flags that configure training come with it.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from wsss_tpu_torch.cli import common
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.data.pipeline import prefetch
from wsss_tpu_torch.eval import metrics, reports
from wsss_tpu_torch.io import artifacts, checkpoint
from wsss_tpu_torch.methods import irnet
from wsss_tpu_torch.methods.gradcam_cues import _normalizer
from wsss_tpu_torch.models.irn import IRNet, edge_displacement_inference
from wsss_tpu_torch.ops.crf.config import IRN_TUNED
from wsss_tpu_torch.ops.filters import resize_nearest
from wsss_tpu_torch.utils.device import resolve_device


def _spec_and_htt(args):
    spec = registry.get(args.dataset)
    htt = args.dataset.split('-')[-1] if args.dataset.startswith('ADP') \
        else None
    return spec, htt


def _native_shape_groups(ds, batchsize):
    """Group native-size single-image batches by exact (H, W), so each
    group runs through one batched MSF forward a scale.  Yields (names,
    imgs [B,H,W,3], tags [B,C])."""
    groups = {}
    for b in prefetch(ds.iter_native()):
        key = b.images.shape[1:3]
        groups.setdefault(key, []).append(b)
        if len(groups[key]) == batchsize:
            batch = groups.pop(key)
            yield ([x.names[0] for x in batch],
                   np.concatenate([x.images for x in batch]),
                   np.concatenate([x.tags for x in batch]))
    for batch in groups.values():
        yield ([x.names[0] for x in batch],
               np.concatenate([x.images for x in batch]),
               np.concatenate([x.tags for x in batch]))


def run_make_cam(args, dirs) -> None:
    spec, htt = _spec_and_htt(args)
    size = common.input_size(args)
    n_out = (51 if args.model == 'X1.7' else
             (31 if htt else spec.n_fg_classes))
    handle = common.load_handle(args, n_out, size)
    scales = tuple(float(s) for s in args.scales.split(','))
    ci = irnet.CAMInference(handle, spec, args.model, scales=scales,
                            adp_htt=htt, device=args.device)
    ds, _ = common.get_batches(args, args.train_split, size)
    n = 0
    # native-size batched MSF: the reference keeps each image's geometry
    # (make_cam.py:41-42); batching groups identical shapes
    for names, imgs, tags in _native_shape_groups(ds, args.batchsize):
        for name, d in zip(names, ci.make_cam_batch(imgs, tags)):
            artifacts.write_cam_npy(
                os.path.join(dirs['cam'], name + '.npy'),
                d['keys'], d['cam'], d.get('high_res'))
            n += 1
    print(f'[make_cam] wrote {n} cam dicts -> {dirs["cam"]}')


def run_eval_cam(args, dirs, split=None) -> float:
    spec, htt = _spec_and_htt(args)
    size = common.input_size(args)
    dev = resolve_device(args.device)
    ds, _ = common.get_batches(args, split or args.train_split, size,
                               htt=htt)
    n_cls = spec.n_seg_classes
    conf = np.zeros((n_cls, n_cls), np.int64)
    # native-size eval: ground truth keeps its geometry (eval_cam.py:75);
    # eval_cam_pred holds the eval_cam.py:48-62 dataset branches
    is_dg = args.dataset.startswith('DeepGlobe')
    for b in prefetch(ds.iter_native(with_gt=True)):
        name = b.names[0]
        path = os.path.join(dirs['cam'], name + '.npy')
        if not os.path.exists(path) or b.gt is None:
            continue
        d = artifacts.read_cam_npy(path)
        pred = irnet.eval_cam_pred(d, args.dataset, args.cam_eval_thres)
        if pred is None:
            continue
        # jax.image.resize's half-pixel nearest (eval_cam.py:75)
        up = resize_nearest(
            torch.as_tensor(pred, dtype=torch.float32, device=dev)[..., None],
            b.gt.shape[1:])[..., 0].to(torch.int32)
        if getattr(args, 'saveimg', False):
            reports.save_color_and_overlay(
                dirs['eval'], name + '_cam', up.cpu().numpy(),
                spec.palette_array(), b.images[0], r=0.25 if is_dg else 0.75)
        conf = metrics.accumulate_confusion(
            conf, up, torch.as_tensor(b.gt[0], device=dev), n_cls)
    iou, miou = metrics.iou_from_confusion(conf)
    prec, rec = metrics.precision_recall_from_confusion(conf)
    # DeepGlobe drops the trailing class name row (eval_cam.py:106-109)
    names = (spec.seg_class_names[:-1] if is_dg else spec.seg_class_names)
    k = len(names)
    reports.write_iou_csv(os.path.join(dirs['eval'], 'cam_iou.csv'),
                          names, np.asarray(iou)[:k],
                          precision=np.asarray(prec)[:k],
                          recall=np.asarray(rec)[:k])
    print(f'[eval_cam, {split or args.train_split}] miou: '
          f'{float(miou):.5f}')
    return float(miou)


def run_cam_to_ir_label(args, dirs) -> None:
    spec, htt = _spec_and_htt(args)
    size = common.input_size(args)
    ds, _ = common.get_batches(args, args.train_split, size)
    n = 0
    # native image geometry: the CRF's guide image matches the cam's
    # high_res grid (cam_to_ir_label.py works on the original image)
    for b in prefetch(ds.iter_native()):
        name = b.names[0]
        path = os.path.join(dirs['cam'], name + '.npy')
        if not os.path.exists(path):
            continue
        conf = irnet.cam_to_ir_label(
            b.images[0], artifacts.read_cam_npy(path), args.dataset,
            conf_fg_thres=args.conf_fg_thres,
            conf_bg_thres=args.conf_bg_thres, device=args.device)
        reports.save_png(os.path.join(dirs['ir_label'], name + '.png'), conf)
        if getattr(args, 'saveimg', False):
            # colorized (255 -> white) + overlay (cam_to_ir_label.py:79-93)
            reports.save_color_and_overlay(
                dirs['ir_label'] + '_clr', name, conf,
                spec.palette_array(), b.images[0],
                ignore_color=(255, 255, 255))
        n += 1
    print(f'[cam_to_ir_label] wrote {n} label maps -> {dirs["ir_label"]}')


def run_make_sem_seg(args, dirs) -> None:
    spec, htt = _spec_and_htt(args)
    size = common.input_size(args)
    dev = resolve_device(args.device)
    crop = args.irn_crop_size or (size // 16 * 16)
    net = IRNet('vgg16' if args.model.startswith('VGG') else 'm7')
    state, _ = checkpoint.restore_checkpoint(dirs['irn_ckpt'],
                                             map_location=dev)
    net.load_state_dict(state['variables'])
    net = net.to(dev).eval()
    disp_mean = state['disp_mean']
    norm = _normalizer(spec.norm_irn, dev)
    ds, _ = common.get_batches(args, args.infer_split, size)
    from wsss_tpu_torch.data import augment
    n = 0
    for b in prefetch(ds.iter_native()):
        name = b.names[0]
        path = os.path.join(dirs['cam'], name + '.npy')
        if not os.path.exists(path):
            continue
        d = artifacts.read_cam_npy(path)
        # top_left crop/pad of the native image to the train crop size
        # (train_irn.py:38 infer_dataset crop_method="top_left")
        img_c = augment.top_left_crop(b.images[0], crop, 0)
        img = norm(torch.as_tensor(img_c[None]).to(dev, torch.float32))
        edge, _ = edge_displacement_inference(net, img, disp_mean)
        pred = irnet.make_sem_seg(
            edge, d, args.dataset, b.images[0].shape[:2],
            beta=args.beta, exp_times=args.exp_times,
            sem_seg_bg_thres=args.sem_seg_bg_thres,
            walk_downsample=args.walk_downsample, device=dev)
        reports.save_png(os.path.join(dirs['sem_seg'], name + '.png'), pred)
        if getattr(args, 'saveimg', False):
            # colorized + overlay (make_sem_seg_labels.py:121-140)
            reports.save_color_and_overlay(
                dirs['sem_seg'] + '_clr', name, pred,
                spec.palette_array(), b.images[0],
                r=0.25 if args.dataset.startswith('DeepGlobe') else 0.75)
        n += 1
    print(f'[make_sem_seg] wrote {n} -> {dirs["sem_seg"]}')


def run_eval_sem_seg(args, dirs) -> float:
    spec, htt = _spec_and_htt(args)
    size = common.input_size(args)
    dev = resolve_device(args.device)
    ds, _ = common.get_batches(args, args.infer_split, size, htt=htt)
    n_cls = spec.n_seg_classes
    conf = np.zeros((n_cls, n_cls), np.int64)
    from PIL import Image
    for b in prefetch(ds.iter_native(with_gt=True)):
        name = b.names[0]
        path = os.path.join(dirs['sem_seg'], name + '.png')
        if not os.path.exists(path) or b.gt is None:
            continue
        pred = np.asarray(Image.open(path)).astype(np.int32)
        pred[pred == 255] = 0  # eval_sem_seg.py:32
        gt = b.gt[0]
        if pred.shape != gt.shape:
            pred = np.asarray(Image.fromarray(
                pred.astype(np.uint8)).resize(gt.shape[::-1],
                                              Image.NEAREST))
        conf = metrics.accumulate_confusion(
            conf, torch.as_tensor(pred.astype(np.int32), device=dev),
            torch.as_tensor(gt, device=dev), n_cls)
    iou, miou = metrics.iou_from_confusion(conf)
    reports.write_iou_csv(os.path.join(dirs['eval'], 'sem_seg_iou.csv'),
                          spec.seg_class_names, np.asarray(iou))
    print(f'[eval_sem_seg] miou: {float(miou):.5f}')
    return float(miou)


PASSES = ['make_cam', 'eval_cam', 'cam_to_ir_label', 'train_irn',
          'make_sem_seg', 'eval_sem_seg']
RUNS = {'make_cam': run_make_cam, 'eval_cam': run_eval_cam,
        'cam_to_ir_label': run_cam_to_ir_label,
        'make_sem_seg': run_make_sem_seg, 'eval_sem_seg': run_eval_sem_seg}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_args(p)
    p.add_argument('--passes', default='all',
                   help=f'comma list from {PASSES} or "all"')
    p.add_argument('--work_root', default='irn_work')
    p.add_argument('--train_split', default='train')
    p.add_argument('--infer_split', default='val')
    p.add_argument('--scales', default='1.0,0.5,1.5,2.0')
    p.add_argument('--cam_eval_thres', type=float, default=0.15)
    p.add_argument('--conf_fg_thres', type=float, default=None,
                   help='default: the tuned per-dataset value '
                        '(demo_sem_seg.py:8-18)')
    p.add_argument('--conf_bg_thres', type=float, default=0.05)
    p.add_argument('--irn_crop_size', type=int, default=0)
    p.add_argument('--beta', type=float, default=10.0)
    p.add_argument('--exp_times', type=int, default=None,
                   help='default: the tuned per-dataset value')
    p.add_argument('--sem_seg_bg_thres', type=float, default=0.25)
    p.add_argument('--walk_downsample', type=int, default=6,
                   help='DeepGlobe pre-walk downsample (reference /6, '
                        'make_sem_seg_labels.py:101-104)')
    p.add_argument('--tune', action='store_true',
                   help='demo_tune.py grid: conf_fg_thres then exp_times')
    p.add_argument('--saveimg', action='store_true',
                   help='write colorized + overlay debug PNGs at each '
                        'pass (eval_cam.py:66-85, cam_to_ir_label.py:'
                        '79-93, make_sem_seg_labels.py:121-140)')
    args = p.parse_args(argv)

    passes = PASSES if args.passes == 'all' else args.passes.split(',')
    if args.tune or 'train_irn' in passes:
        raise NotImplementedError(
            ('--tune trains IRNet, which' if args.tune else
             'the train_irn pass (in --passes all too)')
            + ' is not ported yet (ROADMAP queue 1 item 6b); run '
            '--passes make_cam,eval_cam,cam_to_ir_label,make_sem_seg,'
            'eval_sem_seg with an IRNet checkpoint under irn_ckpt')

    # tuned hyperparameter defaults (demo_sem_seg.py:8-18)
    tuned = IRN_TUNED.get((args.dataset, args.model), (0.5, 8))
    if args.conf_fg_thres is None:
        args.conf_fg_thres = tuned[0]
    if args.exp_times is None:
        args.exp_times = tuned[1]

    root = os.path.join(args.work_root, f'IRN_{args.dataset}_{args.model}')
    dirs = {k: os.path.join(root, k)
            for k in ('cam', 'ir_label', 'sem_seg', 'irn_ckpt', 'eval')}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    result = {}
    for ps in passes:
        r = RUNS[ps](args, dirs)
        if ps == 'eval_cam':
            result['cam_miou'] = r
        elif ps == 'eval_sem_seg':
            result['miou'] = r
    return result


if __name__ == '__main__':
    main()
