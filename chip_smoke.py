#!/usr/bin/env python3
"""Drive wsss_tpu_torch's paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. device  — a CUDA card is required; prints its name and power limit;
  2. build   — nvcc builds every kernel of wsss_tpu_torch/kernels/csrc;
  3. kernels — each kernel against its plain PyTorch version at the
               shapes its paths give it: the v2 route's three at the VOC
               main path's (batch 8, 64x64 guide, C 21 and C 1) and at SEC
               prediction's (one 375x500 image, 38x50 guide); the v1
               route's four and the slice at SEC prediction's (5x7 ragged
               tiles, C 21 and C 1), at the wide path's (batch 2, 32x32
               guide, C 40 and C 1) and, as an extra, at batch 8 (C 21 and
               C 40); the cube blur on a cube too large for one block
               (gc 52).  Error against the stated tolerance (the v1
               kernels: bit-equal, and the same bits on two runs), and
               times from CUDA events (median) beside the bound and a
               library call; the scatter grid's flat colour blur in its
               fused and split forms on the IRNet label CRF's grid
               (9 x 9 x 56^3 cells, C 21) and on the VOC HistoSegNet
               config's scatter grid (C 21 split, C 1 fused); the aligned
               grid's splat and slice at batch 8, 321^2, t 20, gc 16 and
               gc 21, and on a ragged 13x17 image;
  4. main    — HSNSegmenter.segment_batch for VOC2012 with random-init
               full-width VGG16 fg and bg classifiers at 321^2, batch 8,
               the production CRF config: img/s, CAM- and CRF-stage ms,
               launch counts of the timed run (the v2 route's three must
               be > 0), label agreement with the same batch through the
               plain versions;
  5. sec     — predict_image (SEC, full-width DeepLab-LargeFOV, random
               weights) on 4 VOC-sized images at 321: img/s, FCN and CRF
               ms and launch counts on the default (v2) route, then on
               the v1 route (the module flag WSSS_TPU_MXU_V1 sets): label
               agreement between the routes and with the plain versions;
               one DSRG image;
  6. wide    — mean_field at 40 classes, which takes the v1 route without
               a switch (unfused message grid, fused C=1 grid): launch
               counts, Q, argmax agreement with the plain versions;
  7. irn_label — crf_label_refine with IRNet's label CRF on two 321^2
               images of 21 labels on the card (the scatter grid; the
               host's permutohedral library is built first where it can
               be, and must not draw card tensors away): launch counts of
               the flat colour blur read right after the call, label
               agreement with the plain versions; then, counted apart,
               blur_color_axes (split form) on the path's own grids
               against the fused form; one image as CPU tensors through
               the native route where its library builds;
  8. adp_hsn — ADPHSNSegmenter.segment_batch, full-width X1.7 (51-way),
               random weights, batch 8 at 224^2, the default ADP CRFs
               (direct window): img/s, the CRF's share, the window
               against weight maps computed offset by offset, and against
               a cache of them in time, at ADP's shape and at the VOC M7
               config's;
  9. aligned — AlignedBilateralGrid.filter at batch 8, 321^2, C 21:
               launch counts, error against the plain versions;
 10. result  — one JSON line of kernels, then the last line
               {"ok": true, "device": {...}}.
Every path is driven with the launch counts set to 0 just before it and
read just after.  Needs no network and imports nothing of JAX.
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


V2_KERNELS = ('bilateral_splat', 'bilateral_color_blur', 'bilateral_slice')
V1_FUSED = ('bilateral_splat_tiles', 'bilateral_fold_blur',
            'bilateral_slice')
V1_UNFUSED = ('bilateral_splat_tiles', 'bilateral_fold',
              'bilateral_cube_blur', 'bilateral_slice')
ALIGNED = ('bilateral_splat_aligned', 'bilateral_cube_blur',
           'bilateral_slice_aligned')
SCATTER = ('flat_color_blur',)


def check_launches(launches, expected, path):
    """Exactly the kernels of `expected` were launched on `path`."""
    for name, n in launches.items():
        if name in expected:
            check(n > 0, f'{name} was not launched on {path}')
        else:
            check(n == 0, f'{name} was launched {n} times on {path}')


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
    print(f'[build] {len(build.sources())} sources built in {secs:.1f} s '
          f'({build.BUILD_DIR})')


# batch, image size, bilateral sxy of the path's CRF config and the guide
# its mean_field resamples to (8-px cells; wsss_tpu_torch/ops/crf/meanfield.py)
GEOMETRIES = {'hsn': (BATCH, (SIZE, SIZE), 40.0, (GUIDE, GUIDE)),
              'sec': (1, (375, 500), 80.0, (38, 50)),
              'wide': (2, (SIZE, SIZE), 80.0, (32, 32))}


def path_guide(torch, path, gen):
    """A random guide image [B, gh, gw, 3] at the size the path's
    mean_field resamples its images to."""
    from wsss_tpu_torch.ops.crf.meanfield import MXU_DS_CELL
    from wsss_tpu_torch.ops.filters import resize_bilinear
    b, hw, sxy, want = GEOMETRIES[path]
    ghw = tuple(int(round(n * MXU_DS_CELL / sxy)) for n in hw)
    check(ghw == want, f'guide of the {path} path changed: {ghw}')
    imgs = torch.rand((b,) + hw + (3,), generator=gen, device='cuda') * 255
    return resize_bilinear(imgs, ghw)


def hold_v2_kernels(torch, K, geo, x, label):
    """The v2 route's three kernels against their plain versions on one
    geometry; returns ({name: max_abs_err}, the plain splat, blur,
    spatially blurred grid and slice)."""
    b = x.shape[0]
    t, gy, gx, gc, cell = geo.t, geo.gy, geo.gx, geo.gc, geo.cell
    ref_s = K.bilateral_splat_plain(x, cell, t, gy, gx, gc)
    got_s = K.bilateral_splat(x, cell, t, gy, gx, gc)
    ref_b = K.bilateral_color_blur_plain(ref_s, geo.taps)
    got_b = K.bilateral_color_blur(ref_s, geo.taps)
    g_sp = torch.matmul(geo.blur_sp, ref_b.reshape(b, gy * gx, -1)
                        ).view(ref_b.shape)
    ref_l = K.bilateral_slice_plain(g_sp, cell, t)
    got_l = K.bilateral_slice(g_sp, cell, t)
    torch.cuda.synchronize()
    errs = {}
    # splat: atomics sum in a run-dependent order -> f32 rounding;
    # blur and slice use the plain version's operation order with
    # round-to-nearest intrinsics -> bit-equal expected
    for name, got, ref, tol in (
            ('bilateral_splat', got_s, ref_s, 1e-5),
            ('bilateral_color_blur', got_b, ref_b, 1e-6),
            ('bilateral_slice', got_l, ref_l, 1e-6)):
        check(got.shape == ref.shape and torch.isfinite(got).all(),
              f'{name} {label}: shape {tuple(got.shape)} or non-finite')
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        print(f'[kernels] {name} {label}: max_abs_err {err:.3e} '
              f'max_rel_err {err / scale:.3e} (tolerance {tol:g} of '
              f'max |plain| {scale:.4g})')
        check(err <= tol * scale, f'{name} {label} disagrees with plain')
        errs[name] = err
    return errs, ref_s, ref_b, g_sp, ref_l


def phase_kernels(torch):
    """The v2 route's kernels against their plain versions at the shapes
    of the main path (with times, bounds and library calls at C=21) and
    of SEC prediction's default route."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.meanfield import MXU_CELL_MULT
    from wsss_tpu_torch.utils.device import resolve_device
    dev = resolve_device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    guide = path_guide(torch, 'hsn', gen)
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
        errs, ref_s, ref_b, g_sp, ref_l = hold_v2_kernels(
            torch, K, geo, x, f'B={BATCH} {GUIDE}x{GUIDE} C={c}')
        if c != 21:
            continue
        results = {name: {'max_abs_err': err, 'shape': 'hsn_c21',
                          'cases': {}} for name, err in errs.items()}
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

    # the shapes SEC prediction's default route gives the same kernels
    guide = path_guide(torch, 'sec', gen)
    geo = mxu_grid.MXUBilateralGrid(guide, 8.0, 13.0, 21,
                                    cell_mult=MXU_CELL_MULT)
    t, gy, gx, gc, cell = geo.t, geo.gy, geo.gx, geo.gc, geo.cell
    check(geo.v2 and (t, gy, gx, gc) == (8, 6, 8, 16),
          f'SEC geometry changed: {(geo.v2, t, gy, gx, gc)}')
    for c in (21, 1):
        x = torch.rand(tuple(guide.shape[:3]) + (c,), generator=gen,
                       device=dev)
        label = f'B=1 {guide.shape[1]}x{guide.shape[2]} C={c}'
        errs, ref_s, _, g_sp, ref_l = hold_v2_kernels(torch, K, geo, x,
                                                      label)
        gbytes = ref_s.numel() * 4
        rows4 = torch.cat([r.reshape(-1) for r, _ in
                           K.corner_rows(cell, t, gy, gx, gc ** 3)])
        touched = int(torch.unique(rows4).numel())
        case = {
            'bilateral_splat': (
                lambda: K.bilateral_splat(x, cell, t, gy, gx, gc),
                bound_ms(x.numel() * 4 + cell.numel() * 4 + gbytes,
                         4 * 3 * x.numel())),
            'bilateral_color_blur': (
                lambda: K.bilateral_color_blur(ref_s, geo.taps),
                bound_ms(2 * gbytes, 3 * 9 * ref_s.numel())),
            'bilateral_slice': (
                lambda: K.bilateral_slice(g_sp, cell, t),
                bound_ms(touched * c * 4 + cell.numel() * 4
                         + ref_l.numel() * 4, 7 * ref_l.numel()))}
        for name, (fn, (bb, bf)) in case.items():
            ms = cuda_ms(torch, fn)
            results[name]['cases'][f'sec_v2_c{c}'] = dict(
                max_abs_err=errs[name], ms=ms, bound_ms=bb, bound_by=bf)
            print(f'[kernels] {name} {label}: {ms:.4f} ms, bound '
                  f'{bb:.4f} ms ({bf})')
    return results


def hold_v1_kernels(torch, K, geo, x, label):
    """The v1 route's four kernels and the slice on one geometry: each
    bit-equal to its plain version (the tile splat also on two runs),
    timed beside its bound, its plain version and, where one PyTorch call
    computes the same function, that call.  Returns {name: numbers}."""
    dev = x.device
    b, c = x.shape[0], x.shape[-1]
    t, gy, gx, gc, cell, taps = (geo.t, geo.gy, geo.gx, geo.gc, geo.cell,
                                 geo.taps)
    part = K.bilateral_splat_tiles(x, cell, t, gc)
    check(torch.equal(part, K.bilateral_splat_tiles(x, cell, t, gc)),
          f'bilateral_splat_tiles {label}: two runs differ')
    fold = K.bilateral_fold(part)
    fblur = K.bilateral_fold_blur(part, taps)
    cblur = K.bilateral_cube_blur(fold, taps)
    g_sp = torch.matmul(geo.blur_sp, fblur.reshape(b, gy * gx, -1)
                        ).view(fblur.shape)
    sliced = K.bilateral_slice(g_sp, cell, t)
    torch.cuda.synchronize()
    pairs = (
        ('bilateral_splat_tiles', part,
         K.bilateral_splat_tiles_plain(x, cell, t, gc)),
        ('bilateral_fold', fold, K.bilateral_fold_plain(part)),
        ('bilateral_fold_blur', fblur,
         K.bilateral_fold_blur_plain(part, taps)),
        ('bilateral_cube_blur', cblur,
         K.bilateral_cube_blur_plain(fold, taps)),
        ('bilateral_slice', sliced,
         K.bilateral_slice_plain(g_sp, cell, t)))
    res = {}
    for name, got, ref in pairs:
        check(got.shape == ref.shape and torch.isfinite(got).all(),
              f'{name} {label}: shape {tuple(got.shape)} or non-finite')
        err = float((got - ref).abs().max())
        print(f'[kernels] {name} {label}: max_abs_err {err:.3e} '
              f'(bit-equal expected; max |plain| '
              f'{float(ref.abs().max()):.4g})')
        check(torch.equal(got, ref),
              f'{name} {label} is not bit-equal to its plain version')
        res[name] = {'max_abs_err': err}
    del pairs, got, ref
    pbytes, gbytes = part.numel() * 4, fold.numel() * 4

    # yardstick of the tile splat: one index_add_ into the partial
    # layout, rows (tile*4 + q)*gc^3 + cell
    gc3 = gc ** 3
    corner = K.corner_rows(cell, t, gy - 1, gx - 1, gc3, own_tile=True)
    rows4 = torch.cat([((r - cell) * 4 + q * gc3 + cell).reshape(-1)
                       for q, (r, _) in enumerate(corner)])
    vals4 = torch.cat([(w[..., None] * x).reshape(-1, c)
                       for _, w in corner])

    def tiles_lib():
        return torch.zeros((part.numel() // c, c), device=dev
                           ).index_add_(0, rows4, vals4)
    lib_err = float((tiles_lib().view(part.shape) - part).abs().max())
    check(lib_err <= 1e-5 * float(part.abs().max()),
          f'index_add_ yardstick computes another function ({lib_err})')
    bb, bf = bound_ms(pbytes + x.numel() * 4 + cell.numel() * 4,
                      4 * 3 * x.numel())
    res['bilateral_splat_tiles'].update(
        ms=cuda_ms(torch, lambda: K.bilateral_splat_tiles(x, cell, t, gc)),
        plain_ms=cuda_ms(torch, lambda: K.bilateral_splat_tiles_plain(
            x, cell, t, gc), reps=5, warmup=1),
        library_ms=cuda_ms(torch, tiles_lib), bound_ms=bb, bound_by=bf)
    del rows4, vals4, corner

    # yardstick of the fold: F.fold (col2im, 2x2 blocks at stride 1) adds
    # block (ty, tx)'s entry (by, bx) into node (ty + by, tx + bx).  It
    # wants [B, m*4 + q, tile]; that copy of the partials is made outside
    # the timed call and the result is left in F.fold's [B, m, gy, gx]
    m = gc3 * c
    cols = part.view(b, (gy - 1) * (gx - 1), 4, m).permute(0, 3, 2, 1)
    cols = cols.reshape(b, m * 4, -1)

    def fold_lib():
        return torch.nn.functional.fold(cols, (gy, gx), kernel_size=2)
    lib_err = float((fold_lib().permute(0, 2, 3, 1).reshape(fold.shape)
                     - fold).abs().max())
    check(lib_err <= 1e-5 * float(fold.abs().max()),
          f'F.fold yardstick computes another function ({lib_err})')
    bb, bf = bound_ms(pbytes + gbytes, 3 * fold.numel())
    res['bilateral_fold'].update(
        ms=cuda_ms(torch, lambda: K.bilateral_fold(part)),
        plain_ms=cuda_ms(torch, lambda: K.bilateral_fold_plain(part),
                         reps=10),
        library_ms=cuda_ms(torch, fold_lib, reps=10), bound_ms=bb,
        bound_by=bf)
    del cols
    # fold + blur is two PyTorch calls (F.fold, conv3d): no single one
    bb, bf = bound_ms(pbytes + gbytes, (3 + 27) * fold.numel())
    res['bilateral_fold_blur'].update(
        ms=cuda_ms(torch, lambda: K.bilateral_fold_blur(part, taps)),
        plain_ms=cuda_ms(torch, lambda: K.bilateral_fold_blur_plain(
            part, taps), reps=10),
        library_ms=None, bound_ms=bb, bound_by=bf)

    w3 = torch.tensor(taps[::-1] + taps[1:], device=dev)
    w3 = (w3[:, None, None] * w3[None, :, None] * w3[None, None, :])
    w3 = w3.expand(c, 1, 5, 5, 5).contiguous()
    cl3 = fold.view(b * gy * gx, gc, gc, gc, c).permute(0, 4, 1, 2, 3)

    def blur_lib():
        return torch.nn.functional.conv3d(cl3, w3, padding=2, groups=c)
    lib_err = float((blur_lib().permute(0, 2, 3, 4, 1).reshape(
        cblur.shape) - cblur).abs().max())
    check(lib_err <= 1e-4 * float(cblur.abs().max()),
          f'conv3d yardstick computes another function ({lib_err})')
    bb, bf = bound_ms(2 * gbytes, 27 * fold.numel())
    res['bilateral_cube_blur'].update(
        ms=cuda_ms(torch, lambda: K.bilateral_cube_blur(fold, taps)),
        plain_ms=cuda_ms(torch, lambda: K.bilateral_cube_blur_plain(
            fold, taps), reps=10),
        library_ms=cuda_ms(torch, blur_lib, reps=5, warmup=1),
        bound_ms=bb, bound_by=bf,
        three_pass_ms=cuda_ms(
            torch, lambda: K.bilateral_color_blur(fold, taps)))
    rows4 = torch.cat([r.reshape(-1) for r, _ in
                       K.corner_rows(cell, t, gy, gx, gc3)])
    bb, bf = bound_ms(int(torch.unique(rows4).numel()) * c * 4
                      + cell.numel() * 4 + sliced.numel() * 4,
                      7 * sliced.numel())
    res['bilateral_slice'].update(
        ms=cuda_ms(torch, lambda: K.bilateral_slice(g_sp, cell, t)),
        bound_ms=bb, bound_by=bf)
    for name, r in res.items():
        lib = ('not timed' if 'library_ms' not in r
               else 'no single call' if r['library_ms'] is None
               else f'{r["library_ms"]:.4f} ms')
        plain = (f'{r["plain_ms"]:.4f} ms' if 'plain_ms' in r
                 else 'not timed')
        print(f'[kernels] {name} {label}: {r["ms"]:.4f} ms, plain {plain}, '
              f'library {lib}, bound {r["bound_ms"]:.4f} ms '
              f'({r["bound_by"]})')
    print(f'[kernels] colour blur {label}: one pass (bilateral_cube_blur) '
          f'{res["bilateral_cube_blur"]["ms"]:.4f} ms, three passes '
          f'(bilateral_color_blur) '
          f'{res["bilateral_cube_blur"]["three_pass_ms"]:.4f} ms')
    return res


# (geometry, message channels, case prefix); the batch-8 cases are an
# extra that no path of this script runs on the v1 route
V1_CASES = (('sec', 21, 'sec'), ('wide', 40, 'wide'),
            ('hsn', 21, 'b8'), ('hsn', 40, 'b8'))
# where each v1 kernel's headline numbers come from: the path that
# launches it most, at the message filter's width
V1_HEADLINE = {'bilateral_splat_tiles': 'sec_c21',
               'bilateral_fold_blur': 'sec_c21',
               'bilateral_fold': 'wide_c40',
               'bilateral_cube_blur': 'wide_c40'}


def phase_kernels_v1(torch, results):
    """The v1 route's kernels and the slice at the shapes of the SEC v1
    path and the wide path (message grid and C=1 normalizer grid), then
    at batch 8 and on a cube too large for one block.  Adds every case to
    results[name]['cases'] and the new kernels' headline numbers (the case
    of V1_HEADLINE) to results[name]."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.meanfield import MXU_CELL_MULT
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(2)
    flag = mxu_grid._V2_DISABLED
    for path, c, prefix in V1_CASES:
        guide = path_guide(torch, path, gen)
        # SEC prediction reaches the v1 route through the switch; more
        # than 32 classes reach it without
        mxu_grid._V2_DISABLED = flag or path == 'sec'
        try:
            geo = mxu_grid.MXUBilateralGrid(guide, 8.0, 13.0, c,
                                            cell_mult=MXU_CELL_MULT)
            geo1 = mxu_grid.MXUBilateralGrid(guide, 8.0, 13.0, 1,
                                             cell_mult=MXU_CELL_MULT,
                                             share_from=geo)
        finally:
            mxu_grid._V2_DISABLED = flag
        want_v2 = path == 'hsn' and c == 21
        check((geo.v2, geo.fuse_combine_blur) == (want_v2, c == 21)
              and (geo1.v2, geo1.fuse_combine_blur) == (want_v2, True),
              f'routing of {path} C={c} changed: v2 {geo.v2}, fused '
              f'{geo.fuse_combine_blur}')
        b, gh, gw = guide.shape[:3]
        for g, cc in ((geo, c),) + (((geo1, 1),) if prefix != 'b8' else ()):
            x = torch.rand((b, gh, gw, cc), generator=gen, device=dev)
            res = hold_v1_kernels(torch, K, g, x,
                                  f'B={b} {gh}x{gw} C={cc}')
            for name, r in res.items():
                results.setdefault(name, {'cases': {}})['cases'][
                    f'{prefix}_c{cc}'] = r
            del x, res
            torch.cuda.empty_cache()
    for name, case in V1_HEADLINE.items():
        results[name].update(results[name]['cases'][case], shape=case)

    # a cube no block can hold: srgb 5 -> gc 52, 562 KB for one channel
    big = mxu_grid.MXUBilateralGrid(guide[:1], 8.0, 5.0, 1)
    nc, planes = K.cube_tiling(big.gc, 1)
    check(big.gc == 52 and not big.v2 and not big.fuse_combine_blur
          and planes < big.gc, f'large-cube case changed: gc {big.gc}')
    grid = K.bilateral_fold(K.bilateral_splat_tiles(
        torch.ones((1, GUIDE, GUIDE, 1), device=dev), big.cell, big.t,
        big.gc))
    got = K.bilateral_cube_blur(grid, big.taps)
    check(torch.equal(got, K.bilateral_cube_blur_plain(grid, big.taps)),
          'bilateral_cube_blur gc=52 is not bit-equal to its plain version')
    ms = cuda_ms(torch, lambda: K.bilateral_cube_blur(grid, big.taps))
    bb, _ = bound_ms(2 * grid.numel() * 4, 27 * grid.numel())
    print(f'[kernels] bilateral_cube_blur gc=52 C=1 B=1 ({planes} of 52 '
          f'cr-planes a block): bit-equal, {ms:.4f} ms, bound {bb:.4f} ms')
    results['bilateral_cube_blur']['gc52_ms'] = ms


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
    n_batches = 2
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
    check_launches(launches, V2_KERNELS, 'the main path')

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


def phase_sec(torch):
    """SEC prediction at full width on both routes of the grid."""
    from wsss_tpu_torch.cli.sec_dsrg import predict_crf_config, predict_image
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.meanfield import mean_field
    from wsss_tpu_torch.ops.filters import resize_bilinear
    from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor
    spec = registry.get('VOC2012')
    n_cls, hw = spec.n_seg_classes, (375, 500)
    t0 = time.perf_counter()
    pred = SECDSRGPredictor.random('SEC', n_cls, seed=0)
    torch.cuda.synchronize()
    cfg = predict_crf_config('VOC2012', 'SEC')
    print(f'[sec] SECNet built in {time.perf_counter() - t0:.2f} s; '
          f'CRF {cfg}')
    gen = torch.Generator(device='cuda').manual_seed(3)
    images = [torch.randint(0, 256, hw + (3,), dtype=torch.uint8,
                            generator=gen, device='cuda') for _ in range(4)]

    def run(path, expected):
        predict_image(pred, spec, 'SEC', images[0], hw, size=SIZE)  # warm-up
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        labels = [predict_image(pred, spec, 'SEC', im, hw, size=SIZE)
                  for im in images]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        print(f'[sec] {path}: {len(images)} images of {hw[0]}x{hw[1]} at '
              f'{SIZE}: {len(images) / dt:.2f} img/s '
              f'({1e3 * dt / len(images):.2f} ms/img); launches {launches}')
        check_launches(launches, expected, path)
        for lab in labels:
            check(tuple(lab.shape) == hw and lab.dtype == torch.int32,
                  f'labels {tuple(lab.shape)} {lab.dtype}')
            check(int(lab.min()) >= 0 and int(lab.max()) < n_cls,
                  'label out of range')
        return torch.stack(labels), launches

    def stage_ms():
        native = images[0].to(torch.float32)
        norm = _normalizer(spec.norm_sec, pred.device)
        net_in = norm(resize_bilinear(native, (SIZE, SIZE))[None])
        fcn = cuda_ms(torch, lambda: pred.predict_logits(net_in), reps=5,
                      warmup=1)
        probs = torch.softmax(resize_bilinear(
            pred.predict_logits(net_in), hw), dim=-1)
        crf = cuda_ms(torch, lambda: mean_field(probs, native[None], cfg),
                      reps=5, warmup=1)
        return fcn, crf, probs, native[None]

    labels_v2, launches_v2 = run('the SEC path, default route', V2_KERNELS)
    fcn_ms, crf_ms, probs, guide = stage_ms()
    q_v2 = mean_field(probs, guide, cfg)
    print(f'[sec] default route: FCN {fcn_ms:.2f} ms, CRF {crf_ms:.2f} ms '
          f'per image')
    hist = torch.bincount(labels_v2[0].reshape(-1).long(),
                          minlength=n_cls).tolist()
    print(f'[sec] label histogram of image 0: {hist}')

    flag = mxu_grid._V2_DISABLED
    mxu_grid._V2_DISABLED = True        # what WSSS_TPU_MXU_V1=1 sets
    try:
        labels_v1, launches_v1 = run('the SEC path, v1 route', V1_FUSED)
        crf_v1_ms = stage_ms()[1]
        q_v1 = mean_field(probs, guide, cfg)
        with K.plain_versions():
            q_plain = mean_field(probs, guide, cfg)
            labels_plain = torch.stack([
                predict_image(pred, spec, 'SEC', im, hw, size=SIZE)
                for im in images])
    finally:
        mxu_grid._V2_DISABLED = flag
    print(f'[sec] v1 route: CRF {crf_v1_ms:.2f} ms per image')
    routes = float((labels_v1 == labels_v2).float().mean())
    plain = float((labels_v1 == labels_plain).float().mean())
    print(f'[sec] label agreement v1 route vs default route: {routes:.6f}; '
          f'v1 kernels vs plain versions: {plain:.6f}')
    check(routes >= 0.999, f'v1 and default routes agree {routes} < 0.999')
    check(plain >= 0.9999, f'v1 kernels vs plain agree {plain} < 0.9999')
    # random weights give few labels, so hold the posteriors too
    d_routes = float((q_v1 - q_v2).abs().max())
    d_plain = float((q_v1 - q_plain).abs().max())
    print(f'[sec] image 0 posterior: max |dQ| v1 vs default route '
          f'{d_routes:.3e} (tolerance 1e-4: atomic order), v1 kernels vs '
          f'plain versions {d_plain:.3e} (0 expected)')
    check(torch.isfinite(q_v1).all() and d_routes <= 1e-4 and d_plain <= 1e-6,
          'SEC posteriors of the routes disagree')

    dsrg = SECDSRGPredictor.random('DSRG', n_cls, seed=1)
    lab = predict_image(dsrg, spec, 'DSRG', images[1], hw, size=SIZE)
    check(tuple(lab.shape) == hw and lab.dtype == torch.int32
          and int(lab.min()) >= 0 and int(lab.max()) < n_cls,
          'DSRG labels out of shape or range')
    print(f'[sec] DSRGNet image: {int(lab.unique().numel())} labels present')
    return {'sec': launches_v2, 'sec_v1': launches_v1}


def phase_wide(torch):
    """mean_field at 40 classes: the v1 route with no switch."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import config as crf_config
    from wsss_tpu_torch.ops.crf.meanfield import mean_field
    cfg = crf_config.SEC_TEST['VOC2012']
    gen = torch.Generator(device='cuda').manual_seed(4)
    probs = torch.softmax(2 * torch.randn((2, SIZE, SIZE, 40), generator=gen,
                                          device='cuda'), dim=-1)
    imgs = torch.randint(0, 256, (2, SIZE, SIZE, 3), dtype=torch.uint8,
                         generator=gen, device='cuda').to(torch.float32)
    mean_field(probs, imgs, cfg)                          # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    q = mean_field(probs, imgs, cfg)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f'[wide] mean_field C=40, B=2 at {SIZE}^2, {cfg}: launches '
          f'{launches}')
    check_launches(launches, V1_UNFUSED + ('bilateral_fold_blur',),
                   'the wide path')
    check(torch.isfinite(q).all() and q.shape == probs.shape, 'Q not finite')
    check(float((q.sum(-1) - 1).abs().max()) < 1e-4, 'Q rows do not sum to 1')
    ms = cuda_ms(torch, lambda: mean_field(probs, imgs, cfg), reps=5,
                 warmup=1)
    with K.plain_versions():
        q_plain = mean_field(probs, imgs, cfg)
    agree = float((q.argmax(-1) == q_plain.argmax(-1)).float().mean())
    print(f'[wide] CRF {ms:.2f} ms per batch of 2; argmax agreement kernels '
          f'vs plain versions: {agree:.6f}; max |dQ| '
          f'{float((q - q_plain).abs().max()):.3e}')
    check(agree >= 0.9999, f'wide path argmax agrees {agree} < 0.9999')
    return {'wide': launches}


def hold_bit_equal(torch, name, label, got, ref):
    check(got.shape == ref.shape and torch.isfinite(got).all(),
          f'{name} {label}: shape {tuple(got.shape)} or non-finite')
    err = float((got - ref).abs().max())
    print(f'[kernels] {name} {label}: max_abs_err {err:.3e} (bit-equal '
          f'expected; max |plain| {float(ref.abs().max()):.4g})')
    check(torch.equal(got, ref),
          f'{name} {label} is not bit-equal to its plain version')
    return err


def interior(grid, gshape, c):
    """The non-margin cells of a scatter grid [gy, gx, F]: at least 2
    from both ends of every colour axis."""
    gy, gx, gr, gg, gb = gshape
    return grid.view(gy, gx, gr, gg, gb, c)[:, :, 2:-2, 2:-2, 2:-2]


def hold_flat_blur(torch, bg, x, label, want_form, timed):
    """Both forms of the scatter grid's colour blur on the grid `bg`
    scatters from x [1,H,W,C]: the fused form (what BilateralGrid.filter
    runs) and the reference's dispatch (`want_form` says which form it
    must pick here), each bit-equal to its plain version, the two equal
    outside the margin cells.  Returns {kernel name: numbers} for the
    form(s) measured; with `timed`, times, bound and the conv3d
    yardstick too."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import pallas_blur
    c = x.shape[-1]
    gshape = bg.gshape
    g = bg.splat(x)[0]                                   # [gy, gx, F]
    passes = bg.color_passes(c)
    ks, strides = [p[0] for p in passes], [p[1] for p in passes]
    f = g.shape[-1]
    check(pallas_blur.fits_vmem(f) == (want_form == 'fused')
          and pallas_blur.fits_vmem(f // gshape[2]),
          f'dispatch of {label} changed (F = {f})')

    def fused():
        return pallas_blur.color_blur_fused(g, ks, strides)

    def dispatch():
        return pallas_blur.blur_color_axes(g, ks, strides, gshape)
    K.reset_launch_counts()
    got_f, got_d = fused(), dispatch()
    torch.cuda.synchronize()
    check(K.LAUNCHES['flat_color_blur'] == 6,        # 3 passes each
          f'{label}: launches {dict(K.LAUNCHES)}')
    with K.plain_versions():
        ref_f, ref_d = fused(), dispatch()
    res = {'flat_color_blur': {'max_abs_err': hold_bit_equal(
        torch, 'flat_color_blur', label + ' fused form', got_f, ref_f)}}
    err_d = hold_bit_equal(torch, 'flat_color_blur',
                           f'{label} dispatch ({want_form} form)', got_d,
                           ref_d)
    if want_form == 'split':
        res['flat_color_blur_split'] = {'max_abs_err': err_d}
        a, b = interior(got_f, gshape, c), interior(got_d, gshape, c)
        scale = float(a.abs().max())
        d = float((a - b).abs().max())
        print(f'[kernels] flat_color_blur {label}: split vs fused form on '
              f'the non-margin cells: max diff {d:.3e} (tolerance 1e-5 of '
              f'max {scale:.4g}); on all cells '
              f'{float((got_f - got_d).abs().max()):.3e}')
        check(d <= 1e-5 * scale, f'{label}: forms disagree off the margins')
    del ref_f, ref_d, got_d
    fns = {'flat_color_blur': fused, 'flat_color_blur_split': dispatch}
    bb, bf = bound_ms(2 * g.numel() * 4, 27 * g.numel())
    for name, r in res.items():
        r.update(ms=cuda_ms(torch, fns[name], reps=10), bound_ms=bb,
                 bound_by=bf)
        if timed:
            with K.plain_versions():
                r['plain_ms'] = cuda_ms(torch, fns[name], reps=5, warmup=1)
    if timed:
        # yardstick: one depthwise conv3d with the outer product of the
        # three tap sets; it zero-fills every row's end, so it computes
        # the same function on the non-margin cells only
        gy, gx, gr, gg, gb = gshape
        w3 = [torch.tensor(np.asarray(k), device=g.device) for k in ks]
        w3 = (w3[0][:, None, None] * w3[1][None, :, None]
              * w3[2][None, None, :]).expand(c, 1, 5, 5, 5).contiguous()
        cl3 = g.view(gy * gx, gr, gg, gb, c).permute(0, 4, 1, 2, 3)

        def blur_lib():
            return torch.nn.functional.conv3d(cl3, w3, padding=2, groups=c)
        lib = blur_lib().permute(0, 2, 3, 4, 1).reshape(got_f.shape)
        lib_err = float((interior(lib, gshape, c)
                         - interior(got_f, gshape, c)).abs().max())
        check(lib_err <= 1e-3 * float(got_f.abs().max()),
              f'conv3d yardstick computes another function ({lib_err})')
        del lib
        lib_ms = cuda_ms(torch, blur_lib, reps=3, warmup=1)
        for r in res.values():
            r['library_ms'] = lib_ms
    for name, r in res.items():
        extra = (f', plain {r["plain_ms"]:.4f} ms, library (conv3d) '
                 f'{r["library_ms"]:.4f} ms' if timed else '')
        print(f'[kernels] {name} {label}: {r["ms"]:.4f} ms{extra}, bound '
              f'{r["bound_ms"]:.4f} ms ({r["bound_by"]})')
    return res


def structured_case(torch, gen, b, hw, n_labels, flip=0.15):
    """Seeded images [b,H,W,3] of flat-coloured 40-px blocks plus noise,
    and label maps [b,H,W] that follow the blocks with a share `flip` of
    the pixels relabelled at random: something for a CRF to clean."""
    h, w = hw
    nby, nbx = -(-h // 40), -(-w // 40)
    block_lab = torch.randint(0, n_labels, (b, nby, nbx), generator=gen,
                              device='cuda')
    palette = torch.rand((n_labels, 3), generator=gen, device='cuda') * 255
    up = block_lab.repeat_interleave(40, 1).repeat_interleave(40, 2)[
        :, :h, :w]
    imgs = palette[up] + 10 * torch.randn((b, h, w, 3), generator=gen,
                                          device='cuda')
    noise = torch.rand((b, h, w), generator=gen, device='cuda') < flip
    rand_lab = torch.randint(0, n_labels, (b, h, w), generator=gen,
                             device='cuda')
    return imgs.clamp(0, 255), torch.where(noise, rand_lab, up)


def phase_kernels_scatter(torch, results):
    """flat_color_blur in both forms at the IRNet label CRF's grid (the
    headline numbers) and at the VOC HistoSegNet config's scatter grid."""
    from wsss_tpu_torch.ops.crf import config as crf_config
    from wsss_tpu_torch.ops.crf.meanfield import BilateralGrid
    gen = torch.Generator(device='cuda').manual_seed(5)
    imgs, _ = structured_case(torch, gen, 1, (SIZE, SIZE), 21)
    cfg = crf_config.IRN_LABEL
    bg = BilateralGrid(imgs, cfg.bi_sxy, cfg.bi_srgb)
    check(bg.gshape == (9, 9, 56, 56, 56),
          f'IRN label grid changed: {bg.gshape}')
    x = torch.rand((1, SIZE, SIZE, 21), generator=gen, device='cuda')
    res = hold_flat_blur(torch, bg, x, 'IRN label grid 9x9x56^3 C=21',
                         'split', timed=True)
    for name, r in res.items():
        results[name] = dict(r, shape='irn_c21', cases={})
    del res
    torch.cuda.empty_cache()
    ones = torch.ones((1, SIZE, SIZE, 1), device='cuda')
    res = hold_flat_blur(torch, bg, ones, 'IRN label grid 9x9x56^3 C=1',
                         'split', timed=False)
    for name, r in res.items():
        results[name]['cases']['irn_c1'] = r
    cfg = crf_config.hsn_config('VOC2012', 'VGG16')
    bg = BilateralGrid(imgs, cfg.bi_sxy, cfg.bi_srgb)
    check(bg.gshape == (11, 11, 24, 24, 24),
          f'VOC scatter grid changed: {bg.gshape}')
    for xx, c, form in ((x, 21, 'split'), (ones, 1, 'fused')):
        res = hold_flat_blur(torch, bg, xx,
                             f'VOC scatter grid 11x11x24^3 C={c}', form,
                             timed=False)
        for name, r in res.items():
            results[name]['cases'][f'voc_scatter_c{c}'] = r


def phase_kernels_aligned(torch, results):
    """The aligned grid's splat and slice against their plain versions at
    batch 8, 321^2, t 20 (headline: gc 16, C 21; also gc 21) and on a
    ragged 13x17 image."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.meanfield import MXU_CELL_MULT
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = (('b8_gc16', (BATCH, SIZE, SIZE), 40.0, 13.0, 21, MXU_CELL_MULT),
              ('b8_gc21', (BATCH, SIZE, SIZE), 40.0, 13.0, 21, 1.0),
              ('ragged', (2, 13, 17), 6.0, 64.0, 3, 1.0))
    for case, (b, h, w), sxy, srgb, c, mult in shapes:
        imgs = torch.rand((b, h, w, 3), generator=gen, device=dev) * 255
        geo = mxu_grid.AlignedBilateralGrid(imgs, sxy, srgb, c,
                                            cell_mult=mult)
        t, gc, cell = geo.t, geo.gc, geo.cell
        if case != 'ragged':
            check((t, geo.nty, geo.ntx) == (20, 17, 17)
                  and gc == (16 if case == 'b8_gc16' else 21),
                  f'aligned geometry changed: {(t, geo.nty, geo.ntx, gc)}')
        x = torch.rand((b, h, w, c), generator=gen, device=dev)
        label = f'B={b} {h}x{w} t={t} gc={gc} C={c}'
        ref_s = K.bilateral_splat_aligned_plain(x, cell, t, gc)
        got_s = K.bilateral_splat_aligned(x, cell, t, gc)
        g_bl = geo._blur(ref_s)
        ref_l = K.bilateral_slice_aligned_plain(g_bl, cell, t)
        got_l = K.bilateral_slice_aligned(g_bl, cell, t)
        torch.cuda.synchronize()
        check(got_s.shape == ref_s.shape and torch.isfinite(got_s).all(),
              f'bilateral_splat_aligned {label}: shape or non-finite')
        err = float((got_s - ref_s).abs().max())
        scale = float(ref_s.abs().max())
        print(f'[kernels] bilateral_splat_aligned {label}: max_abs_err '
              f'{err:.3e} (tolerance 1e-5 of max |plain| {scale:.4g}: '
              f'atomic order)')
        check(err <= 1e-5 * scale,
              f'bilateral_splat_aligned {label} disagrees with plain')
        res = {'bilateral_splat_aligned': {'max_abs_err': err},
               'bilateral_slice_aligned': {'max_abs_err': hold_bit_equal(
                   torch, 'bilateral_slice_aligned', label, got_l, ref_l)}}
        del got_s, got_l
        if case != 'ragged':
            rows = K._tile_rows(cell, t, gc ** 3)
            flat_rows, vals = rows.reshape(-1), x.reshape(-1, c)

            def splat_lib():
                return torch.zeros((ref_s.numel() // c, c), device=dev
                                   ).index_add_(0, flat_rows, vals)
            g_flat = g_bl.reshape(-1, c)
            check(torch.equal(g_flat[rows], ref_l),
                  'gather yardstick computes another function')
            bb, bf = bound_ms(x.numel() * 4 + cell.numel() * 4
                              + ref_s.numel() * 4, x.numel())
            res['bilateral_splat_aligned'].update(
                ms=cuda_ms(torch, lambda: K.bilateral_splat_aligned(
                    x, cell, t, gc)),
                plain_ms=cuda_ms(torch, lambda:
                                 K.bilateral_splat_aligned_plain(
                                     x, cell, t, gc), reps=10),
                library_ms=cuda_ms(torch, splat_lib, reps=10),
                bound_ms=bb, bound_by=bf)
            touched = int(torch.unique(flat_rows).numel())
            bb, bf = bound_ms(touched * c * 4 + cell.numel() * 4
                              + ref_l.numel() * 4, 0)
            res['bilateral_slice_aligned'].update(
                ms=cuda_ms(torch, lambda: K.bilateral_slice_aligned(
                    g_bl, cell, t)),
                plain_ms=cuda_ms(torch, lambda:
                                 K.bilateral_slice_aligned_plain(
                                     g_bl, cell, t), reps=10),
                library_ms=cuda_ms(torch, lambda: g_flat[rows], reps=10),
                bound_ms=bb, bound_by=bf)
            for name, r in res.items():
                print(f'[kernels] {name} {label}: {r["ms"]:.4f} ms, plain '
                      f'{r["plain_ms"]:.4f} ms, library '
                      f'{r["library_ms"]:.4f} ms, bound '
                      f'{r["bound_ms"]:.4f} ms ({r["bound_by"]})')
        for name, r in res.items():
            if case == 'b8_gc16':
                results[name] = dict(r, shape=case, cases={})
            else:
                results[name]['cases'][case] = r
        del ref_s, g_bl, ref_l, res
        torch.cuda.empty_cache()


def phase_irn_label(torch):
    """crf_label_refine with IRNet's label CRF on the scatter grid."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import config as crf_config
    from wsss_tpu_torch.ops.crf import meanfield as mf
    from wsss_tpu_torch.ops.crf import native, pallas_blur
    cfg, n_labels, n_img = crf_config.IRN_LABEL, 21, 2
    # built or not, the host library must not draw card tensors away
    native_built = native.available() or native.build()
    gen = torch.Generator(device='cuda').manual_seed(7)
    imgs, labels = structured_case(torch, gen, n_img, (SIZE, SIZE),
                                   n_labels)
    check(mf.bilateral_structure((SIZE, SIZE), cfg.bi_sxy, cfg.bi_srgb)
          == 'grid' and not mf._mxu_ok((SIZE, SIZE), n_labels, cfg),
          'the IRN label CRF no longer routes to the scatter grid')
    mf.crf_label_refine(imgs[0], labels[0], n_labels, cfg)       # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    refined = mf.crf_label_refine(imgs, labels, n_labels, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    with K.plain_versions():
        plain = mf.crf_label_refine(imgs, labels, n_labels, cfg)
    print(f'[irn_label] crf_label_refine, {cfg}, {n_img} images of '
          f'{SIZE}^2, {n_labels} labels: {n_img / dt:.2f} img/s '
          f'({1e3 * dt / n_img:.1f} ms/img); launches {launches}')
    # The reference's per-cell dispatch on the path's own grid: at this
    # shape it takes the split form for C 21 and for C 1.  No entry point
    # runs that form (the filter runs whole stripes whatever F is), so
    # these launches are this script's own and are counted apart.
    bg = mf.BilateralGrid(imgs[:1], cfg.bi_sxy, cfg.bi_srgb)
    onehot = torch.nn.functional.one_hot(
        labels[:1].long(), n_labels).to(torch.float32)
    n_split = 0
    for x in (onehot, onehot[..., :1] * 0 + 1):
        c = x.shape[-1]
        g = bg.splat(x)[0]
        passes = bg.color_passes(c)
        ks, strides = [p[0] for p in passes], [p[1] for p in passes]
        check(not pallas_blur.fits_vmem(g.shape[-1]),
              f'the dispatch no longer splits the C={c} grid')
        K.reset_launch_counts()
        split = pallas_blur.blur_color_axes(g, ks, strides, bg.gshape)
        n_split += K.LAUNCHES['flat_color_blur']
        full = K.flat_color_blur(g.view(-1, g.shape[-1]), passes
                                 ).view(g.shape)
        a = interior(full, bg.gshape, c)
        d = float((a - interior(split, bg.gshape, c)).abs().max())
        print(f'[irn_label] blur_color_axes C={c} on the path\'s grid: '
              f'max diff from the full-F form off the margins {d:.3e} '
              f'(tolerance 1e-5 of max {float(a.abs().max()):.4g})')
        check(d <= 1e-5 * float(a.abs().max()),
              f'blur_color_axes C={c} disagrees with the full-F form')
        del g, split, full, a
    torch.cuda.synchronize()
    check_launches(launches, SCATTER, 'the irn_label path')
    want = 3 * (cfg.iterations + 1) * n_img
    check(launches['flat_color_blur'] == want and n_split == 6,
          f'flat_color_blur launches {launches["flat_color_blur"]} from '
          f'crf_label_refine and {n_split} from blur_color_axes, expected '
          f'{want} and 6')
    print(f'[irn_label] blur_color_axes (split form), called by this '
          f'script on the path\'s grids: {n_split} flat_color_blur launches')
    check(refined.shape == labels.shape and refined.dtype == torch.int32
          and int(refined.min()) >= 0 and int(refined.max()) < n_labels,
          'refined labels out of shape or range')
    changed = float((refined != labels).float().mean())
    agree = float((refined == plain).float().mean())
    print(f'[irn_label] the CRF changed {changed:.4f} of the labels; label '
          f'agreement kernels vs plain versions: {agree:.6f}')
    check(agree >= 0.999, f'irn_label labels agree {agree} < 0.999')
    check(changed > 0.01, 'the CRF changed nothing')
    if native_built:
        # CPU tensors: what mean_field sends to the host library
        check(mf._fine_color_native_ok((SIZE, SIZE), cfg),
              'the native route refuses the IRN label CRF')
        t0 = time.perf_counter()
        nat = mf.crf_label_refine(imgs[0].cpu(), labels[0].cpu(), n_labels,
                                  cfg)
        dt = time.perf_counter() - t0
        print(f'[irn_label] native route (CPU tensors, permutohedral): '
              f'{1e3 * dt:.1f} ms for one image; labels agree with the '
              f'scatter grid\'s on '
              f'{float((nat == refined[0].cpu()).float().mean()):.4f}')
    else:
        print('[irn_label] native route: unavailable (the library does '
              'not build here)')
    # the split form's launches, made by this script and counted apart
    return {'irn_label': dict(launches, flat_color_blur_split=n_split)}


def hold_direct_window(torch, imgs, cfg, x, label):
    """DirectBilateral.filter against the same window summed offset by
    offset from weight maps computed one at a time (the reference's
    cached form: the maps are kept, every filter shifts x once per
    offset), in value and in time.  Returns the number of offsets."""
    from wsss_tpu_torch.ops.crf import meanfield as mf
    win = mf.DirectBilateral(imgs, cfg.bi_sxy, cfg.bi_srgb)
    got = win.filter(x)
    h, w = imgs.shape[1:3]
    ones = torch.ones((h, w, 1), device=imgs.device)
    inv = 0.5 / (cfg.bi_srgb * cfg.bi_srgb)

    def wmap(dy, dx, ws):
        d2 = ((imgs - mf._shift2d(imgs, dy, dx)) ** 2).sum(-1)
        return ws * torch.exp(-d2 * inv) * mf._shift2d(ones, dy, dx)[..., 0]
    t0 = time.perf_counter()
    cache = torch.stack([wmap(dy, dx, ws)
                         for (dy, dx), ws in zip(win.offs, win.wspace)])
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)

    def cached_filter():
        out = torch.zeros_like(x)
        for i, (dy, dx) in enumerate(win.offs):
            out = out + cache[i][..., None] * mf._shift2d(x, dy, dx)
        return out
    ref = cached_filter()
    rel = float((got - ref).abs().max() / ref.abs().max())
    ms = cuda_ms(torch, lambda: win.filter(x), reps=3, warmup=1)
    ms_c = cuda_ms(torch, cached_filter, reps=3, warmup=1)
    print(f'[adp_hsn] DirectBilateral {label}, sxy {cfg.bi_sxy:.4g} srgb '
          f'{cfg.bi_srgb:.4g}, {len(win.offs)} offsets: max rel diff from '
          f'the offset-by-offset sum {rel:.3e} (tolerance 1e-4); '
          f'{ms:.2f} ms a filter against {ms_c:.2f} ms from cached weight '
          f'maps ({cache.numel() * 4 / 2 ** 20:.0f} MiB, built in '
          f'{build_ms:.1f} ms)')
    check(torch.isfinite(got).all() and rel <= 1e-4,
          f'direct window {label} disagrees with the offset-by-offset sum')
    return len(win.offs)


def phase_adp_hsn(torch):
    """ADPHSNSegmenter at full width on the direct window."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.methods.hsn import ADPHSNSegmenter
    from wsss_tpu_torch.ops.crf import meanfield as mf
    size = 224
    t0 = time.perf_counter()
    handle = _ClassifierHandle.random('X1.7', 51, size, seed=2)
    seg = ADPHSNSegmenter(handle, 'X1.7')
    torch.cuda.synchronize()
    print(f'[adp_hsn] X1.7 handle built in {time.perf_counter() - t0:.2f} s;'
          f' CRFs {seg.cfg_morph} / {seg.cfg_func}')
    for cfg in (seg.cfg_morph, seg.cfg_func):
        check(mf.bilateral_structure((size, size), cfg.bi_sxy, cfg.bi_srgb)
              == 'direct', f'{cfg} no longer routes to the direct window')
    gen = torch.Generator(device='cuda').manual_seed(8)
    # tissue-like: mostly dark pixels with a bright (background) band
    batch = torch.randint(60, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                          generator=gen, device='cuda')
    batch[:, :, :40] = 250
    seg.segment_batch(batch[:1])                          # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    lab_m, lab_f = seg.segment_batch(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    imgs = batch.to(torch.float32)
    cam_ms = cuda_ms(torch, lambda: seg.probs(imgs), reps=3, warmup=1)
    print(f'[adp_hsn] one batch of {BATCH} at {size}^2: '
          f'{BATCH / dt:.2f} img/s ({1e3 * dt:.1f} ms/batch); CAM stage '
          f'{cam_ms:.2f} ms, so the two CRFs take '
          f'{1 - cam_ms / (1e3 * dt):.3f} of the batch; launches '
          f'{launches}')
    check_launches(launches, (), 'the adp_hsn path (no hand kernel: the '
                   'direct window is plain PyTorch, as in the reference)')
    for lab, spec in ((lab_m, seg.morph_spec), (lab_f, seg.func_spec)):
        check(lab.shape == (BATCH, size, size) and lab.dtype == torch.int32
              and int(lab.min()) >= 0
              and int(lab.max()) < spec.n_seg_classes,
              f'{spec.name} labels out of shape or range')
        print(f'[adp_hsn] {spec.name}: '
              f'{int(lab.unique().numel())} labels present')
    x = torch.rand((2, size, size, 5), generator=gen, device='cuda')
    n_off = hold_direct_window(torch, imgs[:2], seg.cfg_func, x,
                               'ADP func, B 2 C 5')
    check(n_off > 2800, f'ADP window has {n_off} offsets')
    # the VOC M7 HistoSegNet config: a small window (81 offsets)
    from wsss_tpu_torch.ops.crf import config as crf_config
    cfg = crf_config.hsn_config('VOC2012', 'M7')
    check(mf.bilateral_structure((size, size), cfg.bi_sxy, cfg.bi_srgb)
          == 'direct', f'{cfg} no longer routes to the direct window')
    x = torch.rand((BATCH, size, size, 21), generator=gen, device='cuda')
    hold_direct_window(torch, imgs, cfg, x, 'VOC M7, B 8 C 21')
    return {'adp_hsn': launches}


def phase_aligned(torch):
    """AlignedBilateralGrid.filter at the batch-8 shape (a study variant
    in the reference: no entry point builds it, so the class is driven
    directly)."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.meanfield import MXU_CELL_MULT
    gen = torch.Generator(device='cuda').manual_seed(9)
    imgs = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                         generator=gen, device='cuda').to(torch.float32)
    x = torch.softmax(2 * torch.randn((BATCH, SIZE, SIZE, 21), generator=gen,
                                      device='cuda'), dim=-1)
    grid = mxu_grid.AlignedBilateralGrid(imgs, 40.0, 13.0, 21,
                                         cell_mult=MXU_CELL_MULT)
    grid.filter(x)                                        # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = grid.filter(x)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check_launches(launches, ALIGNED, 'the aligned path')
    check(all(launches[k] == 1 for k in ALIGNED),
          f'aligned filter launches {launches}, expected one each')
    ms = cuda_ms(torch, lambda: grid.filter(x), reps=10)
    with K.plain_versions():
        plain = grid.filter(x)
    err = float((out - plain).abs().max())
    scale = float(plain.abs().max())
    print(f'[aligned] AlignedBilateralGrid.filter B={BATCH} {SIZE}^2 C=21 '
          f't={grid.t} gc={grid.gc}: {ms:.3f} ms; launches {launches}; '
          f'max_abs_err vs plain versions {err:.3e} (tolerance 1e-5 of '
          f'max {scale:.4g})')
    check(out.shape == x.shape and torch.isfinite(out).all()
          and err <= 1e-5 * scale, 'aligned filter disagrees with plain')
    return {'aligned': launches}


def main():
    import torch
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    results = phase_kernels(torch)
    phase_kernels_v1(torch, results)
    phase_kernels_scatter(torch, results)
    phase_kernels_aligned(torch, results)
    print(f'[time] kernels done at {time.perf_counter() - t_start:.0f} s')
    paths = {'hsn': phase_main(torch)}
    print(f'[time] main path done at {time.perf_counter() - t_start:.0f} s')
    paths.update(phase_sec(torch))
    paths.update(phase_wide(torch))
    paths.update(phase_irn_label(torch))
    paths.update(phase_adp_hsn(torch))
    paths.update(phase_aligned(torch))
    print(f'[time] all paths done at {time.perf_counter() - t_start:.0f} s')
    from wsss_tpu_torch.kernels import build
    sources = build.sources()
    at = 'wsss_tpu/ops/crf/mxu_grid.py:'
    replaces = {
        'bilateral_splat': at + '289',
        'bilateral_color_blur': at + '356',
        'bilateral_slice': at + '448 (also via _slice :1090)',
        'bilateral_splat_tiles': at + '226',
        'bilateral_fold': at + '414',
        'bilateral_fold_blur': at + '537',
        'bilateral_cube_blur': at + '515 (also via '
                               'AlignedBilateralGrid._blur :1389)',
        'bilateral_splat_aligned': at + '1167 (call :1344)',
        'bilateral_slice_aligned': at + '1203 (call :1411)',
        'flat_color_blur': 'wsss_tpu/ops/crf/pallas_blur.py:47 (call :68)',
        'flat_color_blur_split':
            'wsss_tpu/ops/crf/pallas_blur.py:84 (call :110)'}
    # one kernel serves both forms of the flat colour blur
    source_of = {name: sources[name.replace('_split', '')]
                 for name in replaces}
    check(set(results) == set(replaces)
          and set(sources) == {p.stem for p in source_of.values()},
          f'kernels measured {sorted(results)} vs built {sorted(sources)}')
    kernels = []
    for name, r in results.items():
        by_path = {path: n.get(name, 0) for path, n in paths.items()}
        check(sum(by_path.values()) > 0, f'{name} ran on no path')
        kernels.append(dict(
            name=name, route='cuda',
            source=f'wsss_tpu_torch/kernels/csrc/{source_of[name].name}',
            replaces=replaces[name], launches=sum(by_path.values()),
            max_abs_err=r['max_abs_err'], ms=r['ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
            bound_by=r['bound_by'], library_ms=r['library_ms'],
            launches_by_path=by_path,
            **({'launched_by': 'this script\'s call of blur_color_axes on '
                'the irn_label path\'s grids; no entry point of the port '
                'runs the split form'}
               if name == 'flat_color_blur_split' else {}),
            **{k: r[k] for k in ('shape', 'cases', 'three_pass_ms',
                                 'gc52_ms') if k in r}))
    print('kernels launched on the paths: '
          + ', '.join(k['name'] for k in kernels))
    print(f'[result] card: {smi}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))

if __name__ == '__main__':
    sys.exit(main())
