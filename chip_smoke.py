#!/usr/bin/env python3
"""Drive wsss_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. device  — a CUDA card is required; prints its name and power limit;
  2. build   — nvcc builds every kernel of wsss_tpu_torch/kernels/csrc;
  3. kernels — each kernel against its plain PyTorch version at the VOC
               main path's shapes (64x64 guide, batch 8, gc 16, C 21 and
               C 1): error against the stated tolerance, and times from
               CUDA events (median) beside the bound and a library call;
  4. main    — HSNSegmenter.segment_batch for VOC2012 with random-init
               full-width VGG16 fg and bg classifiers at 321^2, batch 8,
               the production CRF config: img/s, CAM- and CRF-stage ms,
               launch counts of the timed run (each must be > 0), label
               agreement with the same batch through the plain versions;
  5. result  — one JSON line of kernels, then the last line
               {"ok": true, "device": {...}}.
Needs no network and imports nothing of JAX.
"""
import json
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
BATCH, SIZE, GUIDE = 8, 321, 64


def check(cond, msg):
    if not cond:
        raise SystemExit(f'chip_smoke FAILED: {msg}')


def cuda_ms(torch, fn, reps=30, warmup=3):
    """Median ms of fn() over reps runs, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes, n_flops):
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS
    return 1e3 * max(t_b, t_f), ('bytes' if t_b >= t_f else 'operations')


def phase_device(torch):
    check(torch.cuda.is_available(), 'torch.cuda.is_available() is false')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    return smi


def phase_build():
    from wsss_tpu_torch.kernels import build
    secs = build.build(verbose=True)
    for name, log in sorted(build.BUILD_LOG.items()):
        print(f'[build] {name}:\n{log}')
    print(f'[build] {len(build.sources())} kernels built in {secs:.1f} s '
          f'({build.BUILD_DIR})')


def phase_kernels(torch):
    """Each kernel against its plain version on production inputs."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.meanfield import MXU_CELL_MULT
    from wsss_tpu_torch.ops.filters import resize_bilinear
    from wsss_tpu_torch.utils.device import resolve_device
    dev = resolve_device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    imgs = torch.rand((BATCH, SIZE, SIZE, 3), generator=gen,
                      device=dev) * 255
    guide = resize_bilinear(imgs, (GUIDE, GUIDE))
    geo = mxu_grid.MXUBilateralGrid(guide, 8.0, 13.0, 21,
                                    cell_mult=MXU_CELL_MULT)
    t, gy, gx, gc = geo.t, geo.gy, geo.gx, geo.gc
    check((t, gy, gx, gc) == (8, 9, 9, 16),
          f'production geometry changed: {(t, gy, gx, gc)}')
    cell = geo.cell
    results = {}
    for c in (21, 1):
        x = (torch.rand((BATCH, GUIDE, GUIDE, c), generator=gen, device=dev)
             if c > 1 else torch.ones((BATCH, GUIDE, GUIDE, 1), device=dev))
        ref_s = K.bilateral_splat_plain(x, cell, t, gy, gx, gc)
        got_s = K.bilateral_splat(x, cell, t, gy, gx, gc)
        ref_b = K.bilateral_color_blur_plain(ref_s, geo.taps)
        got_b = K.bilateral_color_blur(ref_s, geo.taps)
        g_sp = torch.matmul(geo.blur_sp, ref_b.reshape(BATCH, gy * gx, -1)
                            ).view(ref_b.shape)
        ref_l = K.bilateral_slice_plain(g_sp, cell, t)
        got_l = K.bilateral_slice(g_sp, cell, t)
        torch.cuda.synchronize()
        # splat: atomics sum in a run-dependent order -> f32 rounding;
        # blur and slice use the plain version's operation order with
        # round-to-nearest intrinsics -> bit-equal expected
        for name, got, ref, tol in (
                ('bilateral_splat', got_s, ref_s, 1e-5),
                ('bilateral_color_blur', got_b, ref_b, 1e-6),
                ('bilateral_slice', got_l, ref_l, 1e-6)):
            check(got.shape == ref.shape and torch.isfinite(got).all(),
                  f'{name} C={c}: shape {tuple(got.shape)} or non-finite')
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            print(f'[kernels] {name} C={c}: max_abs_err {err:.3e} '
                  f'max_rel_err {err / scale:.3e} (tolerance {tol:g} of '
                  f'max |plain| {scale:.4g})')
            check(err <= tol * scale, f'{name} C={c} disagrees with plain')
            if c == 21:
                results[name] = {'max_abs_err': err}
        if c != 21:
            continue
        gbytes = ref_s.numel() * 4

        # timings (C=21, the message filter that runs every iteration)
        def splat():
            return K.bilateral_splat(x, cell, t, gy, gx, gc)

        def splat_plain():
            return K.bilateral_splat_plain(x, cell, t, gy, gx, gc)
        corner = K.corner_rows(cell, t, gy, gx, gc ** 3)
        rows4 = torch.cat([r.reshape(-1) for r, _ in corner])
        vals4 = torch.cat([(w[..., None] * x).reshape(-1, c)
                           for _, w in corner])

        def splat_lib():
            return torch.zeros((BATCH * gy * gx * gc ** 3, c),
                               device=dev).index_add_(0, rows4, vals4)
        bb, bf = bound_ms(x.numel() * 4 + cell.numel() * 4 + gbytes,
                          4 * 3 * x.numel())
        results['bilateral_splat'].update(
            ms=cuda_ms(torch, splat), plain_ms=cuda_ms(torch, splat_plain),
            library_ms=cuda_ms(torch, splat_lib), bound_ms=bb, bound_by=bf)

        w3 = torch.tensor(geo.taps[::-1] + geo.taps[1:], device=dev)
        w3 = (w3[:, None, None] * w3[None, :, None] * w3[None, None, :])
        w3 = w3.expand(c, 1, 5, 5, 5).contiguous()
        cl3 = ref_s.view(BATCH * gy * gx, gc, gc, gc, c).permute(0, 4, 1,
                                                                 2, 3)

        def blur_lib():
            return torch.nn.functional.conv3d(cl3, w3, padding=2, groups=c)
        lib_out = blur_lib().permute(0, 2, 3, 4, 1).reshape(ref_b.shape)
        lib_err = float((lib_out - ref_b).abs().max())
        check(lib_err <= 1e-4 * float(ref_b.abs().max()),
              f'conv3d yardstick computes another function ({lib_err})')
        bb, bf = bound_ms(2 * gbytes, 3 * 9 * ref_s.numel())
        results['bilateral_color_blur'].update(
            ms=cuda_ms(torch, lambda: K.bilateral_color_blur(ref_s,
                                                             geo.taps)),
            plain_ms=cuda_ms(torch, lambda: K.bilateral_color_blur_plain(
                ref_s, geo.taps), reps=20),
            library_ms=cuda_ms(torch, blur_lib), bound_ms=bb, bound_by=bf)

        n_pix = cell.numel()
        s_idx = torch.stack([
            torch.arange(n_pix, device=dev).repeat(4), rows4])
        s_val = torch.cat([w.expand(cell.shape).reshape(-1)
                           for _, w in corner])
        with warnings.catch_warnings():     # CSR support is 'beta'
            warnings.simplefilter('ignore', UserWarning)
            smat = torch.sparse_coo_tensor(
                s_idx, s_val, (n_pix, BATCH * gy * gx * gc ** 3),
                check_invariants=False).coalesce().to_sparse_csr()
        g_flat = g_sp.reshape(-1, c)

        def slice_lib():
            return torch.sparse.mm(smat, g_flat)
        lib_err = float((slice_lib().view(ref_l.shape) - ref_l).abs().max())
        check(lib_err <= 1e-5 * float(ref_l.abs().max()),
              f'sparse.mm yardstick computes another function ({lib_err})')
        touched = int(torch.unique(rows4).numel())
        bb, bf = bound_ms(touched * c * 4 + cell.numel() * 4
                          + ref_l.numel() * 4, 7 * ref_l.numel())
        results['bilateral_slice'].update(
            ms=cuda_ms(torch, lambda: K.bilateral_slice(g_sp, cell, t)),
            plain_ms=cuda_ms(torch, lambda: K.bilateral_slice_plain(
                g_sp, cell, t)),
            library_ms=cuda_ms(torch, slice_lib), bound_ms=bb, bound_by=bf)
    for name, r in results.items():
        print(f'[kernels] {name} C=21: {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} ms, '
              f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]})')
    return results


def phase_main(torch):
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.methods.hsn import HSNSegmenter
    from wsss_tpu_torch.ops.crf.meanfield import mean_field
    spec = registry.get('VOC2012')
    t0 = time.perf_counter()
    fg = _ClassifierHandle.random('VGG16', spec.n_fg_classes, SIZE, seed=0)
    bg = _ClassifierHandle.random('VGG16', spec.n_fg_classes, SIZE, seed=1)
    seg = HSNSegmenter(spec, fg, bg, model_type='VGG16')
    torch.cuda.synchronize()
    print(f'[main] handles built in {time.perf_counter() - t0:.2f} s; '
          f'CRF {seg.cfg}')
    gen = torch.Generator(device='cuda').manual_seed(1)
    n_batches = 3
    batches = [torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                             dtype=torch.uint8, generator=gen,
                             device='cuda') for _ in range(n_batches)]
    seg.segment_batch(batches[0])                         # warm-up
    torch.cuda.synchronize()

    K.reset_launch_counts()
    t0 = time.perf_counter()
    labels = [seg.segment_batch(b) for b in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    print(f'[main] {n_batches} batches of {BATCH} at {SIZE}^2: '
          f'{BATCH * n_batches / dt:.2f} img/s '
          f'({1e3 * dt / n_batches:.2f} ms/batch)')
    print(f'[main] launches in the timed run: {launches}')
    for name, n in launches.items():
        check(n > 0, f'{name} was not launched on the main path')

    imgs = batches[0].to(torch.float32)
    cam_ms = cuda_ms(torch, lambda: seg.probs(imgs), reps=5, warmup=1)
    probs = seg.probs(imgs)
    crf_ms = cuda_ms(torch, lambda: mean_field(probs, imgs, seg.cfg),
                     reps=5, warmup=1)
    q = mean_field(probs, imgs, seg.cfg)
    print(f'[main] CAM stage {cam_ms:.2f} ms, CRF stage {crf_ms:.2f} ms '
          f'per batch of {BATCH}')
    for lab in labels:
        check(lab.shape == (BATCH, SIZE, SIZE) and lab.dtype == torch.int32,
              f'labels {tuple(lab.shape)} {lab.dtype}')
        check(int(lab.min()) >= 0 and int(lab.max()) < spec.n_seg_classes,
              'label out of range')
    check(torch.isfinite(q).all() and q.shape == probs.shape, 'Q not finite')
    check(float((q.sum(-1) - 1).abs().max()) < 1e-4, 'Q rows do not sum to 1')
    hist = torch.bincount(labels[0].reshape(-1).long(),
                          minlength=spec.n_seg_classes).tolist()
    print(f'[main] label histogram of batch 0: {hist}')

    with K.plain_versions():
        plain = seg.segment_batch(batches[0])
    agree = float((plain == labels[0]).float().mean())
    print(f'[main] label agreement kernels vs plain versions: {agree:.6f}')
    check(agree >= 0.999, f'kernel path labels agree {agree} < 0.999')
    return launches


def main():
    import torch
    smi = phase_device(torch)
    phase_build()
    results = phase_kernels(torch)
    launches = phase_main(torch)
    from wsss_tpu_torch.kernels import build
    sources = build.sources()
    replaces = {
        'bilateral_splat': 'wsss_tpu/ops/crf/mxu_grid.py:289',
        'bilateral_color_blur': 'wsss_tpu/ops/crf/mxu_grid.py:356',
        'bilateral_slice': 'wsss_tpu/ops/crf/mxu_grid.py:448'}
    kernels = []
    for name, r in results.items():
        kernels.append(dict(
            name=name, route='cuda',
            source=f'wsss_tpu_torch/kernels/csrc/{sources[name].name}',
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r['max_abs_err'], ms=r['ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
            bound_by=r['bound_by'], library_ms=r['library_ms']))
    print('kernels launched on the main path: '
          + ', '.join(k['name'] for k in kernels))
    print(f'[result] card: {smi}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
