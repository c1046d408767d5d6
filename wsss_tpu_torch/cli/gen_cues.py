"""CLI of the port: 02_cues — Grad-CAM weak-cue generation + cue
evaluation (counterpart of ``wsss_tpu/cli/gen_cues.py``).

Rebuilds 02_cues/demo.py:641-664 (gen_cues / gen_cues_adp / eval_cues):
generates the localization_cues.pickle for the requested dataset/model and
optionally evaluates cue mIoU vs GT.  Runs on ``--device`` (default the
card); on synthetic data when no devkit is given:

    python -m wsss_tpu_torch.cli.gen_cues --dataset VOC2012 --task eval
"""
from __future__ import annotations

import argparse
import os

from wsss_tpu_torch.cli import common
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.eval import reports
from wsss_tpu_torch.io import artifacts
from wsss_tpu_torch.methods import gradcam_cues as gc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_common_args(p)
    p.add_argument('--task', default='gen', choices=['gen', 'eval'])
    p.add_argument('--thresh', type=float, default=0.2)
    p.add_argument('--split', default='train')
    p.add_argument('--set_name', default=None,
                   choices=[None, 'tuning', 'segtest', 'evaluation'],
                   help="ADP evaluation set (02_cues/demo.py:41; "
                        "'evaluation' is 03b's name for segtest)")
    p.add_argument('--cues_root', default='cues')
    p.add_argument('--saveimg', action='store_true',
                   help='colorized + overlay PNGs for evaluated cues '
                        '(02_cues/demo.py:466-477)')
    args = p.parse_args(argv)

    size = common.input_size(args)
    sid = common.sess_id(args, args.set_name)
    if args.thresh != 0.2:   # 02_cues/demo.py:70-71 naming quirk
        sid += '_' + str(args.thresh)
    cues_dir = os.path.join(args.cues_root, sid)

    if args.dataset.startswith('ADP'):
        handle = common.load_handle(
            args, 51 if args.model == 'X1.7' else 31, size)
        gen = gc.ADPCueGenerator(handle, args.model, thresh=args.thresh,
                                 device=handle.device)
        ds, batches = common.get_batches(args, args.split, size)
        out_m, out_f = gen.run(batches, verbose=args.verbose)
        for htt, out in (('morph', out_m), ('func', out_f)):
            path = os.path.join(cues_dir, htt, 'localization_cues.pickle')
            artifacts.write_cue_pickle(path, out)
            print(f'wrote {len(out) // 2} images -> {path}')
        result = {}
        if args.task == 'eval':
            for htt, out in (('morph', out_m), ('func', out_f)):
                spec = registry.get(f'ADP-{htt}')
                ds2, batches2 = common.get_batches(
                    args, args.split, size, with_gt=True, htt=htt)
                iou, miou = gc.eval_cues_miou(out, batches2,
                                              spec.n_seg_classes,
                                              dataset=f'ADP-{htt}',
                                              size=size)
                path = os.path.join(args.eval_root, sid, htt,
                                    'cues_iou.csv')
                reports.write_iou_csv(path, spec.seg_class_names, iou)
                print(f'[eval_cues, ADP-{htt}] miou: {miou:.5f}')
                result[f'cue_miou_{htt}'] = miou
                if args.saveimg:
                    _, b3 = common.get_batches(args, args.split, size,
                                               with_gt=True, htt=htt)
                    gc.save_cue_images(
                        out, b3, spec.palette_array(),
                        os.path.join(args.out_root, sid, htt),
                        spec.n_seg_classes, dataset=f'ADP-{htt}')
        return result

    spec = registry.get(args.dataset)
    fg = common.load_handle(args, spec.n_fg_classes, size, seed=0)
    bg = None
    if spec.uses_bg_net:
        bg = common.load_handle(args, spec.n_fg_classes, size, seed=1,
                                suffix='bg')
    gen = gc.VOCDeepGlobeCueGenerator(spec, fg, bg, thresh=args.thresh,
                                      device=fg.device)
    ds, batches = common.get_batches(args, args.split, size)
    out = gen.run(batches, verbose=args.verbose)
    # train-style splits (train / train_aug / train75 / train37.5) get
    # the training-cue name consumed by 03a (02_cues/demo.py:217-222);
    # eval splits get the _val name (demo.py:320-321)
    name = ('localization_cues.pickle' if args.split.startswith('train')
            else 'localization_cues_val.pickle')
    path = os.path.join(cues_dir, name)
    artifacts.write_cue_pickle(path, out)
    print(f'wrote {len(out) // 2} images -> {path}')

    if args.task == 'eval':
        ds2, batches2 = common.get_batches(args, args.split, size,
                                           with_gt=True)
        iou, miou = gc.eval_cues_miou(out, batches2, spec.n_seg_classes,
                                      dataset=args.dataset)
        # DeepGlobe drops the trailing 'unknown' class (demo.py:413-415)
        names = (spec.seg_class_names[:-1]
                 if args.dataset.startswith('DeepGlobe')
                 else spec.seg_class_names)
        path = os.path.join(args.eval_root, sid, 'cues_iou.csv')
        reports.write_iou_csv(path, names, iou)
        print(f'[eval_cues, {args.dataset}] miou: {miou:.5f}')
        if args.saveimg:
            _, b3 = common.get_batches(args, args.split, size,
                                       with_gt=True)
            r = 0.25 if args.dataset.startswith('DeepGlobe') else 0.75
            gc.save_cue_images(out, b3, spec.palette_array(),
                               os.path.join(args.out_root, sid),
                               spec.n_seg_classes,
                               dataset=args.dataset, overlay_r=r)
        return {'cue_miou': miou}


if __name__ == '__main__':
    main()
