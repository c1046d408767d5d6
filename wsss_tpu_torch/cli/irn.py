"""CLI of the port: 03b — the IRNet pipeline (counterpart of
``wsss_tpu/cli/irn.py``): make_cam -> eval_cam -> cam_to_ir_label ->
train_irn -> make_sem_seg -> eval_sem_seg, and ``--tune``, the
reference's grid search over conf_fg_thres then exp_times
(demo_tune.py:45-95).  Runs on ``--device`` (default the card); on
synthetic data when no devkit is given, with a random classifier unless
``--model_root`` holds its triplet:

    python -m wsss_tpu_torch.cli.irn --dataset VOC2012 --model VGG16

Intermediate artifacts keep the reference's on-disk contract (.npy cam
dicts, ir-label PNGs) under ``--work_root/IRN_<dataset>_<model>``.
train_irn writes the IRNet to the run's ``irn_ckpt`` directory as a
``torch.save`` file of ``{'variables': IRNet.state_dict(), 'disp_mean':
tensor [2]}`` at step 0 (``io.checkpoint``; a re-run overwrites it), and
make_sem_seg restores it; an orbax checkpoint of the JAX package does not
load, and make_sem_seg raises FileNotFoundError without one.
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
from wsss_tpu_torch.models.backbones import init_random
from wsss_tpu_torch.models.irn import IRNet, edge_displacement_inference
from wsss_tpu_torch.ops.crf.config import IRN_TUNED
from wsss_tpu_torch.ops.filters import resize_nearest
from wsss_tpu_torch.utils.device import resolve_device
from wsss_tpu_torch.utils.timing import profile_trace


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
    mesh = common.get_mesh(args)
    n = 0
    # native-size batched MSF: the reference keeps each image's geometry
    # (make_cam.py:41-42); batching groups identical shapes
    for names, imgs, tags in _native_shape_groups(ds, args.batchsize):
        for name, d in zip(names, ci.make_cam_batch(imgs, tags,
                                                    mesh=mesh)):
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


def affinity_example(img, lab, args, crop, path_index, n_classes, rng):
    """One (img, (bg_pos, fg_pos, neg)) training example, mirroring
    VOC12AffinityDataset (voc12/dataloader.py:255-321) as the reference's
    CLI builds it: the image arrives resized; optional random rescale,
    the shared-coin horizontal flip, the shared-box random crop or the
    top-left crop, then the /4 label reduction feeding
    ``affinity_labels``.  img: [H,W,3] uint8; lab: [H,W] int (255 =
    ignore); rng: the run's numpy Generator, drawn in the reference's
    order."""
    from wsss_tpu_torch.data import augment
    rescale = (tuple(float(v) for v in args.rescale_range.split(','))
               if args.rescale_range else None)
    if rescale:
        img, lab = augment.random_scale([img, lab], rescale, (3, 0), rng)
    if not args.irn_no_flip:
        img, lab = augment.random_lr_flip([img, lab], rng)
    if args.crop_method == 'random':
        img, lab = augment.random_crop([img, lab], crop, (0, 255), rng)
    else:
        img = img[:crop, :crop]
        lab = lab[:crop, :crop]
    g = crop // 4
    lab4 = augment.pil_rescale(lab, 0.25, 0)[:g, :g]
    return img, irnet.affinity_labels(lab4, path_index, n_classes)


def run_train_irn(args, dirs):
    """train_irn (train_irn.py:14-168): the heads on the classifier's
    transplanted trunk, then the displacement-mean calibration; writes
    the checkpoint make_sem_seg restores.  Returns the trainer.  With
    --mesh each step runs over the mesh's 'data' shards (the checkpoint
    from shard 0's replica); the calibration runs unsharded."""
    spec, htt = _spec_and_htt(args)
    size = common.input_size(args)
    dev = resolve_device(args.device)
    crop = args.irn_crop_size or (size // 16 * 16)
    backbone = 'vgg16' if args.model.startswith('VGG') else 'm7'
    norm = _normalizer(spec.norm_irn, dev)
    ds, _ = common.get_batches(args, args.train_split, crop)
    n_imgs = len(ds)
    max_step = max(1, (n_imgs // args.batchsize) * args.irn_epochs)
    if args.rescale_range and args.crop_method != 'random':
        raise SystemExit('--rescale_range requires --crop_method random '
                         '(the reference only combines them, '
                         'func_sample.py:147-148)')
    mesh = common.dp_train_putters(args)
    tr = irnet.IRNTrainer(backbone, crop, lr=args.irn_lr, max_step=max_step,
                          device=dev)
    tr.init(torch.Generator().manual_seed(0))
    if args.irn_random_trunk:
        init_random(tr.net.trunk, torch.Generator().manual_seed(0))
    else:
        # pour the trained classifier into the frozen trunk
        # (net/common_cnn.py:25-42 semantics; see models/transplant.py)
        from wsss_tpu_torch.models.transplant import \
            transplant_classifier_trunk
        n_out = (51 if args.model == 'X1.7' else
                 (31 if htt else spec.n_fg_classes))
        handle = common.load_handle(args, n_out, size)
        transplant_classifier_trunk(handle.model, tr.net, backbone)
        del handle
    from PIL import Image
    from wsss_tpu_torch.data import augment
    rng = np.random.default_rng(11)

    def load_label(name, hw):
        path = os.path.join(dirs['ir_label'], name + '.png')
        if os.path.exists(path):
            lab = np.asarray(Image.open(path)).astype(np.int64)
            return augment.pil_resize(lab, hw, 0)
        return np.full(hw, 255, np.int64)

    def to_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    with profile_trace(args.profile_dir):
        for epoch in range(args.irn_epochs):
            # shuffle=True per epoch (train_irn.py:81-82 DataLoader
            # contract); an incomplete batch is dropped
            for b in prefetch(ds.batches(args.batchsize, shuffle=True)):
                if b.images.shape[0] != args.batchsize:
                    continue
                pairs = [affinity_example(
                    b.images[i], load_label(name, b.images[i].shape[:2]),
                    args, crop, tr.path_index, spec.n_seg_classes, rng)
                    for i, name in enumerate(b.names)]
                imgs = norm(to_dev(np.stack([p[0] for p in pairs]))
                            .to(torch.float32))
                bg, fg, ng = (to_dev(np.stack(z))
                              for z in zip(*[p[1] for p in pairs]))
                parts = tr.train_step(imgs, bg, fg, ng, mesh=mesh)
                if args.verbose:
                    print('  irn loss %.4f' % float(parts['total']))
        # displacement mean calibration over the whole infer split
        # (train_irn.py:152-165; drop_last=True DataLoader contract),
        # streamed a batch at a time
        def infer_batches():
            for b in ds.batches(args.batchsize):
                if b.images.shape[0] == args.batchsize:
                    yield norm(to_dev(b.images[:, :crop, :crop])
                               .to(torch.float32))
        disp_mean = (tr.calibrate_disp_mean(infer_batches())
                     if n_imgs >= args.batchsize else np.zeros(2, np.float32))
    checkpoint.save_checkpoint(
        dirs['irn_ckpt'], 0,
        {'variables': tr.net.state_dict(),
         'disp_mean': torch.from_numpy(disp_mean)})
    print(f'[train_irn] trained; disp_mean={disp_mean}')
    return tr


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
    mesh = common.get_mesh(args)
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
            walk_downsample=args.walk_downsample, mesh=mesh, device=dev)
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
        'cam_to_ir_label': run_cam_to_ir_label, 'train_irn': run_train_irn,
        'make_sem_seg': run_make_sem_seg, 'eval_sem_seg': run_eval_sem_seg}


def tune(args, dirs, run_name) -> None:
    """demo_tune.py:45-95: sweep conf_fg_thres at the dataset's initial
    exp_times (CFG init_exp_times, demo_tune.py:14-23), then sweep
    exp_times over EXP_RNG excluding the initial value (quirk kept:
    demo_tune.py:79 filters it out, so init_exp cannot be re-chosen).
    Every trial is logged as a row of tuning_logs/<run>.tsv in the
    working directory (demo_tune.py:50,68,87-88)."""
    os.makedirs('tuning_logs', exist_ok=True)
    tsv = os.path.join('tuning_logs', run_name + '.tsv')
    with open(tsv, 'a') as f:
        f.write('dataset\tmodel\tconf_fg_thres\texp_times\t'
                'validation miou\n')

    def log_trial(th, exp, miou):
        with open(tsv, 'a') as f:
            f.write(f'{args.dataset}\t{args.model}\t{th:.1f}\t{exp}\t'
                    f'{miou:f}\n')

    init_exp = args.exp_times
    run_make_cam(args, dirs)
    best_th, best_miou = None, -1.0
    for th in (0.3, 0.5, 0.7):      # THRES_RNG, demo_tune.py:24
        args.conf_fg_thres = th
        run_cam_to_ir_label(args, dirs)
        run_train_irn(args, dirs)
        args.exp_times = init_exp
        run_make_sem_seg(args, dirs)
        miou = run_eval_sem_seg(args, dirs)
        log_trial(th, init_exp, miou)
        if miou > best_miou:
            best_th, best_miou = th, miou
    args.conf_fg_thres = best_th
    run_cam_to_ir_label(args, dirs)
    run_train_irn(args, dirs)
    best_exp, best_exp_miou = init_exp, best_miou
    for exp in [x for x in range(1, 9) if x != init_exp]:  # EXP_RNG
        args.exp_times = exp
        run_make_sem_seg(args, dirs)
        miou = run_eval_sem_seg(args, dirs)
        log_trial(best_th, exp, miou)
        if miou > best_exp_miou:
            best_exp, best_exp_miou = exp, miou
    print(f'[tune] best conf_fg_thres={best_th} '
          f'exp_times={best_exp} miou={best_exp_miou:.5f}')


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
    p.add_argument('--profile_dir', default=None,
                   help='torch.profiler Chrome trace output dir of '
                        'train_irn')
    p.add_argument('--irn_epochs', type=int, default=1)
    p.add_argument('--irn_lr', type=float, default=0.1)
    p.add_argument('--crop_method', default=None,
                   choices=[None, 'random', 'top_left'],
                   help='affinity-crop mode; the vgg16/m7 configs use '
                        'outsize resize (None), resnet50 uses random '
                        '(func_sample.py:131-148)')
    p.add_argument('--rescale_range', default=None,
                   help='e.g. 0.5,1.5 — random_scale range for affinity '
                        'training (resnet50 config, func_sample.py:148)')
    p.add_argument('--irn_no_flip', action='store_true',
                   help='disable the shared hor_flip of image+ir_label '
                        '(reference trains with hor_flip=True, '
                        'train_irn.py:29)')
    p.add_argument('--irn_random_trunk', action='store_true',
                   help='skip loading the trained classifier into the '
                        'frozen trunk (debug only; the reference always '
                        'transplants, net/common_cnn.py:25-42)')
    p.add_argument('--beta', type=float, default=10.0)
    p.add_argument('--exp_times', type=int, default=None,
                   help='default: the tuned per-dataset value')
    p.add_argument('--sem_seg_bg_thres', type=float, default=0.25)
    p.add_argument('--walk_downsample', type=int, default=6,
                   help='DeepGlobe pre-walk downsample (reference /6, '
                        'make_sem_seg_labels.py:101-104); lower it when '
                        'sharding the walk over a mesh')
    p.add_argument('--tune', action='store_true',
                   help='demo_tune.py grid: conf_fg_thres then exp_times')
    p.add_argument('--saveimg', action='store_true',
                   help='write colorized + overlay debug PNGs at each '
                        'pass (eval_cam.py:66-85, cam_to_ir_label.py:'
                        '79-93, make_sem_seg_labels.py:121-140)')
    args = p.parse_args(argv)

    # tuned hyperparameter defaults (demo_sem_seg.py:8-18)
    tuned = IRN_TUNED.get((args.dataset, args.model), (0.5, 8))
    if args.conf_fg_thres is None:
        args.conf_fg_thres = tuned[0]
    if args.exp_times is None:
        args.exp_times = tuned[1]

    passes = PASSES if args.passes == 'all' else args.passes.split(',')
    if args.tune or 'train_irn' in passes:
        common.dp_train_putters(args)     # an indivisible batch exits here
    run_name = f'IRN_{args.dataset}_{args.model}'
    root = os.path.join(args.work_root, run_name)
    dirs = {k: os.path.join(root, k)
            for k in ('cam', 'ir_label', 'sem_seg', 'irn_ckpt', 'eval')}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    if args.tune:
        tune(args, dirs, run_name)
        return

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
