"""CLI of the port: 03c — HistoSegNet inference + evaluation (counterpart
of ``wsss_tpu/cli/hsn.py``).

Rebuilds 03c_hsn/demo.py:466-481 (segment / segment_adp): CAM + dense CRF
segmentation over the evaluation split, mIoU + confusion + colorized
overlays.  Runs on ``--device`` (default the card); on synthetic data
when no devkit is given, with random weights unless ``--model_root``
holds the triplets:

    python -m wsss_tpu_torch.cli.hsn --dataset VOC2012
    python -m wsss_tpu_torch.cli.hsn --dataset ADP-morph --model X1.7

``--mesh auto|N`` cuts every batch over a device mesh; the prefetch
thread places the next batch while the current one is segmented.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from wsss_tpu_torch.cli import common
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.eval import metrics, reports
from wsss_tpu_torch.methods import hsn
from wsss_tpu_torch.ops.crf import config as crf_config
from wsss_tpu_torch.ops.filters import resize_nearest
from wsss_tpu_torch.parallel.mesh import mesh_batches


def _to_gt_size(pred: torch.Tensor, gt_hw) -> torch.Tensor:
    """Labels [B,H,W] nearest-resized to the ground truth's [Hg,Wg] on
    their device (no-op where they agree)."""
    if tuple(pred.shape[1:]) == tuple(gt_hw):
        return pred
    return resize_nearest(pred.to(torch.float32)[..., None],
                          gt_hw)[..., 0].to(torch.int32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_args(p)
    p.add_argument('--split', default='val')
    p.add_argument('--set_name', default=None,
                   choices=[None, 'tuning', 'segtest', 'evaluation'])
    p.add_argument('--saveimg', action='store_true')
    p.add_argument('--overlay_r', type=float, default=0.75)
    p.add_argument('--morph_pcc', default=None,
                   help='learned morph CRF config .npy '
                        '(03c_hsn/demo.py:379 morph_optimal_pcc.npy)')
    p.add_argument('--func_pcc', default=None,
                   help='learned func CRF config .npy')
    args = p.parse_args(argv)

    size = common.input_size(args)
    sid = 'HSN_' + common.sess_id(args, args.set_name)
    out_dir = os.path.join(args.out_root, sid)
    mesh = common.get_mesh(args)

    if args.dataset.startswith('ADP'):
        handle = common.load_handle(
            args, 51 if args.model == 'X1.7' else 31, size)
        cfg_m = (crf_config.load_learned_config(args.morph_pcc)
                 if args.morph_pcc else None)
        cfg_f = (crf_config.load_learned_config(args.func_pcc)
                 if args.func_pcc else None)
        seg = hsn.ADPHSNSegmenter(handle, args.model, cfg_morph=cfg_m,
                                  cfg_func=cfg_f, device=handle.device)
        split = args.set_name or 'segtest'
        result = {}
        for htt in ('morph', 'func'):
            spec = registry.get(f'ADP-{htt}')
            ds, batches = common.get_batches(args, split, size,
                                             with_gt=True, htt=htt)
            conf = np.zeros((spec.n_seg_classes,) * 2, np.int64)
            # prefetch-placed batches: the upload overlaps the previous
            # batch's segment step
            for b, (ims,), b0 in mesh_batches(mesh, batches,
                                              lambda b: (b.images,)):
                lm, lf = seg.segment_batch(ims, mesh=mesh)
                pred = (lm if htt == 'morph' else lf)[:b0]
                if b.gt is not None:
                    conf = metrics.accumulate_confusion(
                        conf, _to_gt_size(pred, b.gt.shape[1:]),
                        torch.as_tensor(b.gt, device=pred.device),
                        spec.n_seg_classes)
                if args.saveimg:
                    pred = pred.cpu().numpy()
                    for i, name in enumerate(b.names):
                        reports.save_png(
                            os.path.join(out_dir, htt, name + '.png'),
                            reports.colorize(pred[i],
                                             spec.palette_array()))
            iou, miou = metrics.iou_from_confusion(conf)
            reports.write_iou_csv(
                os.path.join(args.eval_root, sid, htt, 'hsn_iou.csv'),
                spec.seg_class_names, iou)
            print(f'[hsn, ADP-{htt}] miou: {miou:.5f}')
            result[f'miou_{htt}'] = miou
        return result

    spec = registry.get(args.dataset)
    fg = common.load_handle(args, spec.n_fg_classes, size, seed=0)
    bg = None
    if spec.uses_bg_net:
        bg = common.load_handle(args, spec.n_fg_classes, size, seed=1,
                                suffix='bg')
    seg = hsn.HSNSegmenter(spec, fg, bg, model_type=args.model,
                           device=fg.device)
    ds, batches = common.get_batches(args, args.split, size, with_gt=True)
    conf = np.zeros((spec.n_seg_classes,) * 2, np.int64)
    for b, (ims,), b0 in mesh_batches(mesh, batches, lambda b: (b.images,)):
        pred = seg.segment_batch(ims, mesh=mesh)[:b0]
        if b.gt is not None:
            # eval at native GT resolution (03c_hsn/demo.py:233-269
            # compares against the full-size masks)
            pred = _to_gt_size(pred, b.gt.shape[1:])
            conf = metrics.accumulate_confusion(
                conf, pred, torch.as_tensor(b.gt, device=pred.device),
                spec.n_seg_classes)
        if args.saveimg:
            pred = pred.cpu().numpy()
            for i, name in enumerate(b.names):
                color = reports.colorize(pred[i], spec.palette_array())
                reports.save_png(os.path.join(out_dir, name + '.png'),
                                 color)
                reports.save_png(
                    os.path.join(out_dir, name + '_overlay.png'),
                    reports.overlay(np.uint8(b.images[i]), color,
                                    args.overlay_r))
    iou, miou = metrics.iou_from_confusion(conf)
    reports.write_iou_csv(
        os.path.join(args.eval_root, sid, 'hsn_iou.csv'),
        spec.seg_class_names, iou)
    print(f'[hsn, {args.dataset}] miou: {miou:.5f}')
    return {'miou': miou}


if __name__ == '__main__':
    main()
