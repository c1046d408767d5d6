#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

    python3 scripts/profile_torch_hsn.py

Builds the main path of chip_smoke.py (HSNSegmenter, VOC2012, random-init
VGG16 fg and bg, production CRF config) and, for the CAM stage, the CRF
stage and the whole segment_batch, runs a torch.profiler window of
ITERS calls at batch 8, 321^2.  Prints per stage: host wall ms per call, device kernel ms
per call, the device's idle share of the window, the device time by
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
    ('bilateral kernels', r'bilateral_'),
    ('batchnorm', r'bn_fw|batch_norm'),
    ('convolution', r'conv|implicit|fprop|winograd|fft|DSE::|'
                    r'pointwise_mult_and_sum_complex|cudnn'),
    ('matmul', r'gemm|xmma|cutlass|cublas|sgemm|splitK|dot_kernel'),
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


def main():
    import torch
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
    for stage, fn in (
            ('cam', lambda: seg.probs(imgs)),
            ('crf', lambda: mean_field(probs, imgs, seg.cfg)),
            ('segment_batch', lambda: seg.segment_batch(raw))):
        prof, wall_ms, busy_ms, kernels = profile_window(torch, fn, ITERS)
        if not kernels:
            raise SystemExit(f'{stage}: the profiler recorded no device '
                             'time')
        out[stage] = report(stage, wall_ms, busy_ms, kernels, TOP)
    trace = ROOT / 'out' / 'torch_hsn_trace.json'
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    print(f'[trace] {trace.relative_to(ROOT)}')
    out['img_per_s'] = BATCH / (out['segment_batch']['wall_ms'] / 1e3)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
