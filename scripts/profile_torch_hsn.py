#!/usr/bin/env python3
"""Where the time of the PyTorch port's paths goes, on one CUDA card.

    python3 scripts/profile_torch_hsn.py

Builds the main path of chip_smoke.py (HSNSegmenter, VOC2012, random-init
VGG16 fg and bg, production CRF config) and, for the CAM stage, the CRF
stage and the whole segment_batch, runs a torch.profiler window of
ITERS calls at batch 8, 321^2.  Then the SEC prediction path of
chip_smoke.py (SECNet, one 375x500 image at 321): the FCN, the test CRF
on the grid's default route and on its v1 route, and the whole
predict_image.  Then chip_smoke.py's irn_label path (crf_label_refine
with IRNet's label CRF on the scatter grid, one 321^2 image, and one
C 21 filter of that grid alone) and its adp_hsn path (ADPHSNSegmenter,
X1.7, batch 8 at 224^2: the whole segment_batch and the morph CRF on
the direct window, one call each).  Then cue generation (chip_smoke.py's
cues path: VOCDeepGlobeCueGenerator, VGG16 fg + bg, batch 8 at 321^2:
generate_batch on card tensors and run on one host batch), the main
path's two stages under the bf16 opt-ins (bf16 classifiers, bf16 CRF
state), and the train steps of chip_smoke.py's train phase (``train``:
VGG16 classifier, SEC, DSRG, batch 8 at 321^2, one step a call), and
IRNet's 03b stages on one 375x500 image (``irn``: make_cam, the ir-label
CRF, the edge inference, make_sem_seg with its random walk), and the
IRNet train steps of chip_smoke.py's irn_train paths (``irn_train``:
vgg16 at crop 320, m7 at crop 224, batch 8, one step a call).
``--only`` picks sections.  Prints per stage: host wall ms per
call, device kernel ms per call, the device's idle share of the window, the device time by
kernel group and the top kernels.  The idle share is 1 - (union of the
kernels' intervals) / window, since summed kernel time can exceed the
window where kernels overlap.  Writes the segment_batch window's chrome
trace to out/torch_hsn_trace.json and ends with one JSON line of
the numbers.  Imports nothing of JAX.
"""
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
BATCH, SIZE, ITERS, TOP = 8, 321, 3, 12

GROUPS = (                       # first match wins, on the kernel's name
    ('bilateral kernels', r'bilateral_|flat_color_blur'),
    ('scatter / gather', r'index|gather|scatter'),
    ('batchnorm', r'bn_fw|batch_norm'),
    ('convolution', r'conv|implicit|fprop|winograd|fft|DSE::|'
                    r'pointwise_mult_and_sum_complex|cudnn'),
    ('matmul', r'gemm|xmma|cutlass|cublas|sgemm|splitK|dot_kernel'),
    ('optimizer', r'multi_tensor_apply'),
    ('resize', r'upsample|interp|antialias|bilinear'),
    ('softmax / reductions', r'softmax|reduce|max|argmax|sum'),
    ('memset / copy', r'memset|memcpy|copy|fill|CatArray|cat_'),
    ('elementwise', r'elementwise|vectorized|unrolled|pointwise'),
)


def group_of(name):
    for g, pat in GROUPS:
        if re.search(pat, name, re.I):
            return g
    return 'other'


def profile_window(torch, fn, iters):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float('-inf')         # union of kernel intervals, us
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels[e.key] = (us / 1e3 / iters, e.count / iters)
    return prof, 1e3 * wall / iters, busy / 1e3 / iters, kernels


def report(stage, wall_ms, busy_ms, kernels, top):
    dev_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + ms
    idle = 1.0 - busy_ms / wall_ms
    print(f'[{stage}] host wall {wall_ms:.3f} ms/call, device kernels '
          f'{dev_ms:.3f} ms/call summed, device busy {busy_ms:.3f} ms/call, '
          f'idle share {idle:.4f}, '
          f'{sum(n for _, n in kernels.values()):.0f} launches/call')
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f'[{stage}]   {g:22s} {ms:9.3f} ms  {ms / dev_ms:6.1%}')
    for name, (ms, n) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f'[{stage}]     {ms:9.3f} ms x{n:5.0f}  {name[:110]}')
    return {'wall_ms': wall_ms, 'device_ms': dev_ms, 'busy_ms': busy_ms,
            'idle_share': idle, 'groups_ms': groups}


def profile_sec(torch, gen):
    """The SEC prediction path, one 375x500 image at a time."""
    from wsss_tpu_torch.cli.sec_dsrg import predict_crf_config, predict_image
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.meanfield import mean_field
    from wsss_tpu_torch.ops.filters import resize_bilinear
    from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor
    spec = registry.get('VOC2012')
    hw = (375, 500)
    pred = SECDSRGPredictor.random('SEC', spec.n_seg_classes, seed=0)
    cfg = predict_crf_config('VOC2012', 'SEC')
    raw = torch.randint(0, 256, hw + (3,), dtype=torch.uint8, generator=gen,
                        device='cuda')
    native = raw.to(torch.float32)
    net_in = _normalizer(spec.norm_sec, pred.device)(
        resize_bilinear(native, (SIZE, SIZE))[None])
    probs = torch.softmax(resize_bilinear(pred.predict_logits(net_in), hw),
                          dim=-1)

    def crf_v1():
        flag, mxu_grid._V2_DISABLED = mxu_grid._V2_DISABLED, True
        try:
            return mean_field(probs, native[None], cfg)
        finally:
            mxu_grid._V2_DISABLED = flag
    out = {}
    for stage, fn in (
            ('sec_fcn', lambda: pred.predict_logits(net_in)),
            ('sec_crf', lambda: mean_field(probs, native[None], cfg)),
            ('sec_crf_v1', crf_v1),
            ('sec_predict_image', lambda: predict_image(
                pred, spec, 'SEC', raw, hw, size=SIZE))):
        _, wall_ms, busy_ms, kernels = profile_window(torch, fn, ITERS)
        if not kernels:
            raise SystemExit(f'{stage}: the profiler recorded no device '
                             'time')
        out[stage] = report(stage, wall_ms, busy_ms, kernels, TOP)
    out['sec_img_per_s'] = 1e3 / out['sec_predict_image']['wall_ms']
    return out


def profile_stages(torch, stages, out):
    """Profile (stage, fn, iters) one after the other into out[stage]."""
    for stage, fn, iters in stages:
        _, wall_ms, busy_ms, kernels = profile_window(torch, fn, iters)
        if not kernels:
            raise SystemExit(f'{stage}: the profiler recorded no device '
                             'time')
        out[stage] = report(stage, wall_ms, busy_ms, kernels, TOP)
    return out


def profile_irn_label(torch, gen):
    """IRNet's label CRF on the scatter grid, on the card."""
    from chip_smoke import structured_case
    from wsss_tpu_torch.ops.crf import config as crf_config
    from wsss_tpu_torch.ops.crf import meanfield as mf
    cfg, n_labels = crf_config.IRN_LABEL, 21
    imgs, labels = structured_case(torch, gen, 1, (SIZE, SIZE), n_labels)
    bg = mf.BilateralGrid(imgs, cfg.bi_sxy, cfg.bi_srgb)
    x = torch.rand((1, SIZE, SIZE, n_labels), generator=gen, device='cuda')
    return profile_stages(torch, (
        ('irn_label', lambda: mf.crf_label_refine(
            imgs[0], labels[0], n_labels, cfg), ITERS),
        ('irn_filter_c21', lambda: bg.filter(x), ITERS)), {})


def profile_adp(torch, gen):
    """ADP HistoSegNet on the direct window, batch 8 at 224^2."""
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.methods.hsn import ADPHSNSegmenter
    from wsss_tpu_torch.ops.crf.meanfield import mean_field
    size = 224
    seg = ADPHSNSegmenter(_ClassifierHandle.random('X1.7', 51, size, seed=2),
                          'X1.7')
    raw = torch.randint(60, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                        generator=gen, device='cuda')
    raw[:, :, :40] = 250
    imgs = raw.to(torch.float32)
    cs_m, _ = seg.probs(imgs)
    out = profile_stages(torch, (
        ('adp_cam', lambda: seg.probs(imgs), ITERS),
        ('adp_morph_crf', lambda: mean_field(cs_m, imgs, seg.cfg_morph), 1),
        ('adp_segment_batch', lambda: seg.segment_batch(raw), 1)), {})
    out['adp_img_per_s'] = BATCH / (out['adp_segment_batch']['wall_ms'] / 1e3)
    return out


def profile_cues(torch, gen):
    """Cue generation (f32), and the main path's CAM and CRF stages under
    the bf16 opt-ins, batch 8 at 321^2."""
    import os
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.methods import gradcam_cues as gc
    from wsss_tpu_torch.methods.hsn import HSNSegmenter
    from wsss_tpu_torch.ops.crf import meanfield as mf
    spec = registry.get('VOC2012')
    n = spec.n_fg_classes
    handles = [gc._ClassifierHandle.random('VGG16', n, SIZE, seed=s)
               for s in (0, 1)]
    cue_gen = gc.VOCDeepGlobeCueGenerator(spec, *handles)
    batch = next(SyntheticWSSS('VOC2012', size=SIZE,
                               n_images=BATCH).batches(BATCH))
    x = torch.as_tensor(batch.images, device='cuda')
    tags = torch.as_tensor(batch.tags, device='cuda')
    os.environ['WSSS_TPU_BF16_INFER'] = '1'
    try:
        b16 = [gc._ClassifierHandle.random('VGG16', n, SIZE, seed=s)
               for s in (0, 1)]
    finally:
        del os.environ['WSSS_TPU_BF16_INFER']
    seg16 = HSNSegmenter(spec, *b16, model_type='VGG16')
    raw = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                        generator=gen, device='cuda')
    imgs = raw.to(torch.float32)
    probs = HSNSegmenter(spec, *handles, model_type='VGG16').probs(imgs)

    def crf_bf16_state():
        mf._CRF_STATE_BF16 = True
        try:
            return mf.mean_field(probs, imgs, seg16.cfg)
        finally:
            mf._CRF_STATE_BF16 = False
    return profile_stages(torch, (
        ('cues_generate_batch', lambda: cue_gen.generate_batch(x, tags),
         ITERS),
        ('cues_run', lambda: cue_gen.run([batch]), ITERS),
        ('cam_bf16', lambda: seg16.probs(imgs), ITERS),
        ('crf_bf16_state', crf_bf16_state, ITERS)), {})


def profile_train(torch, gen):
    """The train steps of chip_smoke.py's train phase at full width, one
    synthetic batch of 8 at 321^2: ClassifierTrainer on VGG16 (BN, 20
    classes, dropout on) and SECDSRGTrainer for SEC and DSRG (21 classes,
    synthetic cues as the CLI makes them)."""
    from wsss_tpu_torch.cli.sec_dsrg import _synthetic_cues
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.models.backbones import build_classifier
    from wsss_tpu_torch.train.classifier import ClassifierTrainer
    from wsss_tpu_torch.train.sec_dsrg import SECDSRGTrainer
    spec = registry.get('VOC2012')
    b = next(SyntheticWSSS('VOC2012', size=SIZE, n_images=BATCH)
             .batches(BATCH, with_gt=True))
    raw = torch.as_tensor(b.images, device='cuda')
    tags = torch.as_tensor(b.tags, device='cuda')
    cls = ClassifierTrainer(build_classifier('VGG16', spec.n_fg_classes),
                            lr=0.01, schedule='const')
    cls.init(torch.Generator().manual_seed(0))
    x_cls = _normalizer(spec.norm_cues, 'cuda')(raw)
    x_sec = _normalizer(spec.norm_sec, 'cuda')(raw)
    cues, labels = (torch.as_tensor(a, device='cuda') for a in
                    _synthetic_cues(b.gt, spec.n_seg_classes, 41, 0))
    stages = [('train_cls', lambda: cls.train_step(x_cls, tags, gen),
               ITERS)]
    for method in ('SEC', 'DSRG'):
        tr = SECDSRGTrainer(method, spec.n_seg_classes)
        tr.init(torch.Generator().manual_seed(0))
        stages.append((f'train_{method.lower()}',
                       lambda tr=tr: tr.train_step(x_sec, raw, cues, labels,
                                                   gen), ITERS))
    out = profile_stages(torch, stages, {})
    for name in ('train_cls', 'train_sec', 'train_dsrg'):
        out[name + '_img_per_s'] = BATCH / (out[name]['wall_ms'] / 1e3)
    return out


def profile_irn(torch, gen):
    """IRNet's 03b stages on one 375x500 VOC image (chip_smoke.py's
    irn_voc, VGG16 seed 0, IRNet heads seed 1): make_cam at the four
    scales, cam_to_ir_label, the edge inference and make_sem_seg (the
    walk, n = 11 750, 8 squarings)."""
    from chip_smoke import IRN_VOC_HW, irn_edges, irn_images, irn_net
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.ops.crf import config as crf_config
    spec = registry.get('VOC2012')
    conf_fg, exp_times = crf_config.IRN_TUNED[('VOC2012', 'VGG16')]
    handle = _ClassifierHandle.random('VGG16', spec.n_fg_classes, SIZE,
                                      seed=0)
    ci = irnet.CAMInference(handle, spec, 'VGG16')
    net = irn_net(torch, 'vgg16', handle.model, seed=1)
    imgs, tags = irn_images(torch, 11, 1, IRN_VOC_HW, spec.n_fg_classes)
    crop = SIZE // 16 * 16
    d = ci.make_cam(imgs[0], tags[0])
    (edge,) = irn_edges(torch, net, spec, imgs, crop)
    return profile_stages(torch, (
        ('irn_make_cam', lambda: ci.make_cam(imgs[0], tags[0]), ITERS),
        ('irn_cam_to_ir_label', lambda: irnet.cam_to_ir_label(
            imgs[0], d, 'VOC2012', conf_fg), ITERS),
        ('irn_edge', lambda: irn_edges(torch, net, spec, imgs, crop), ITERS),
        ('irn_make_sem_seg', lambda: irnet.make_sem_seg(
            edge, d, 'VOC2012', IRN_VOC_HW, exp_times=exp_times), 1)), {})


def profile_irn_train(torch, gen):
    """chip_smoke.py's irn_train paths, one IRNTrainer step a call at
    batch 8 on its synthetic batch: vgg16 at crop 320 on the irn_voc
    classifier's trunk, m7 at crop 224 on an ADP X1.7 classifier's."""
    from chip_smoke import TRAIN_STEPS, irn_train_batch
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import (_ClassifierHandle,
                                                     _normalizer)
    from wsss_tpu_torch.models.transplant import transplant_classifier_trunk
    stages = []
    for name, dataset, model, n_out, seed, backbone, crop in (
            ('irn_train_voc', 'VOC2012', 'VGG16', 20, 0, 'vgg16', 320),
            ('irn_train_adp', 'ADP-morph', 'X1.7', 51, 2, 'm7', 224)):
        spec = registry.get(dataset)
        clf = _ClassifierHandle.random(model, n_out, SIZE, seed=seed)
        tr = irnet.IRNTrainer(backbone, crop_size=crop,
                              max_step=TRAIN_STEPS)
        tr.init(torch.Generator().manual_seed(1))
        transplant_classifier_trunk(clf.model, tr.net, backbone)
        imgs, labels, _ = irn_train_batch(21, BATCH, crop,
                                          spec.n_seg_classes, tr.path_index)
        x = _normalizer(spec.norm_irn, 'cuda')(
            torch.from_numpy(imgs).to('cuda', torch.float32))
        dev = [torch.from_numpy(a).to('cuda') for a in labels]
        stages.append((name, lambda tr=tr, x=x, dev=dev: tr.train_step(
            x, *dev), ITERS))
    out = profile_stages(torch, stages, {})
    for name, _, _ in stages:
        out[name + '_img_per_s'] = BATCH / (out[name]['wall_ms'] / 1e3)
    return out


SECTIONS = ('main', 'sec', 'irn_label', 'adp', 'cues', 'train', 'irn',
            'irn_train')


def main():
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument('--only', nargs='+', choices=SECTIONS,
                    default=list(SECTIONS))
    only = ap.parse_args().only
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_hsn: needs a CUDA card')
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import build
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.methods.hsn import HSNSegmenter
    from wsss_tpu_torch.ops.crf.meanfield import mean_field
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f'[card] {smi}')
    print(f'[build] {build.build():.1f} s')
    spec = registry.get('VOC2012')
    fg = _ClassifierHandle.random('VGG16', spec.n_fg_classes, SIZE, seed=0)
    bg = _ClassifierHandle.random('VGG16', spec.n_fg_classes, SIZE, seed=1)
    seg = HSNSegmenter(spec, fg, bg, model_type='VGG16')
    gen = torch.Generator(device='cuda').manual_seed(1)
    raw = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                        dtype=torch.uint8, generator=gen, device='cuda')
    imgs = raw.to(torch.float32)
    probs = seg.probs(imgs)
    out = {'card': smi, 'batch': BATCH, 'size': SIZE}
    if 'main' in only:
        for stage, fn in (
                ('cam', lambda: seg.probs(imgs)),
                ('crf', lambda: mean_field(probs, imgs, seg.cfg)),
                ('segment_batch', lambda: seg.segment_batch(raw))):
            prof, wall_ms, busy_ms, kernels = profile_window(torch, fn,
                                                             ITERS)
            if not kernels:
                raise SystemExit(f'{stage}: the profiler recorded no '
                                 'device time')
            out[stage] = report(stage, wall_ms, busy_ms, kernels, TOP)
        trace = ROOT / 'out' / 'torch_hsn_trace.json'
        trace.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(trace))
        print(f'[trace] {trace.relative_to(ROOT)}')
        out['img_per_s'] = BATCH / (out['segment_batch']['wall_ms'] / 1e3)
    for section, fn in (('sec', profile_sec), ('irn_label', profile_irn_label),
                        ('adp', profile_adp), ('cues', profile_cues),
                        ('train', profile_train), ('irn', profile_irn),
                        ('irn_train', profile_irn_train)):
        if section in only:
            out.update(fn(torch, gen))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
