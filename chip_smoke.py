#!/usr/bin/env python3
"""Drive wsss_tpu_torch's paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. device  — a CUDA card is required; prints its name and power limit;
  2. build   — nvcc builds every kernel of wsss_tpu_torch/kernels/csrc;
  3. kernels — each kernel against its plain PyTorch version at the
               shapes its paths give it: the v2 route's three at the VOC
               main path's (batch 8, 64x64 guide, C 21 and C 1) and at SEC
               prediction's (one 375x500 image, 38x50 guide), the colour
               blur also at the v2 route's largest cube (gc 24, C 32: a
               plan of channel groups); the v1 route's four and the
               slice at SEC prediction's (5x7 ragged tiles, C 21 and
               C 1), at the wide path's (batch 2, 32x32 guide, C 40 and
               C 1) and, as an extra, at batch 8 (C 21 and C 40); the
               v1 route's finest cube (gc 52, where the tile splat is
               held too); the cube blur on the aligned filter's grid
               and, on one-run inputs, the slice's and the fold's fixed
               cost (device times beside the previous design's).  Error
               against the stated tolerance (the two atomic splats, v2
               and aligned: 1e-5 of the max; every other kernel
               bit-equal, and the tile splat the same bits on two runs),
               and times from CUDA events (the median of
               one call, and a call's share of a CUDA graph of 10 calls
               back to back: the device's time) beside the bound and a
               library call, timed both ways; the v2 route's colour blur
               against the v1 route's cube blur on the v1 shapes (B 8
               223 MB, wide 33 MB, SEC 4 MB); the scatter grid's flat
               colour blur in its fused and split forms on the IRNet
               label CRF's grid (9 x 9 x 56^3 cells, C 21 and C 1) and
               on the VOC HistoSegNet config's scatter grid (C 21, C 1);
               the aligned grid's splat and slice at batch 8, 321^2,
               t 20, gc 16 and gc 21, and on a ragged 13x17 image;
  4. main    — HSNSegmenter.segment_batch for VOC2012 with random-init
               full-width VGG16 fg and bg classifiers at 321^2, batch 8,
               the production CRF config: img/s, CAM- and CRF-stage ms,
               launch counts of the timed run (the v2 route's three must
               be > 0, the colour blur once a filter), label agreement
               with the same batch through the plain versions;
     cues    — Grad-CAM cue generation (the 02_cues stage):
               VOCDeepGlobeCueGenerator.run with full-width VGG16 fg + bg
               over 16 synthetic VOC images at 321^2 in batches of 8
               (img/s, CAM-to-cues ms a batch, cue pixels per class; no
               hand kernel may launch) and ADPCueGenerator('X1.7') at
               224^2; one batch of 2 on the card against the CPU (labels
               equal, cues agree on >= 0.999 of the seed pixels); both
               generators again with WSSS_TPU_BF16_INFER=1 handles (img/s,
               agreement with float32);
     precision — the main path with bf16 classifiers, with the bf16 CRF
               state (meanfield._CRF_STATE_BF16), and with both: img/s,
               CAM and CRF ms, launches (the main path's), label
               agreement with the float32 run on the same batch, and the
               CRF posterior Q against the float32 one on the same CAM
               batch (max and mean |dQ|, argmax agreement); each mode
               fails outside PRECISION_BOUNDS;
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
               the flat colour blur read right after the call (one a
               filter), label agreement with the plain versions; then,
               counted apart, blur_color_axes (split form) on the path's
               own grids against the fused form; one image as CPU tensors
               through the native route where its library builds;
  8. adp_hsn — ADPHSNSegmenter.segment_batch, full-width X1.7 (51-way),
               random weights, batch 8 at 224^2, the default ADP CRFs
               (direct window: one direct_window launch a filter, 12 a
               batch): img/s, the CRF's share; the window against its
               plain version and weight maps computed offset by offset,
               in time against its bound, the plain version and a cache
               of the maps, and in the memory a filter adds, at every
               shape the path gives it (each CRF's C 1 and C classes,
               batch 8) and at the VOC M7 config's;
  9. aligned — AlignedBilateralGrid.filter at batch 8, 321^2, C 21:
               launch counts, error against the plain versions;
 10. cli     — the command lines in-process, as a user runs them, in a
               temporary directory: which optional libraries (PIL,
               matplotlib, h5py) import here; cli.hsn.main on VOC2012
               (random VGG16 fg + bg at 321^2, 16 synthetic images in
               batches of 8; exactly 22 launches of each v2 kernel and no
               other; csv and xlsx agree; mIoU and, with PIL, the labels of
               its PNGs against segment_batch on the same images; img/s
               beside segment_batch's), on ADP-morph X1.7 with learned CRF
               .npy files (direct_window only), cli.sec_dsrg.main --task
               predict restoring a port checkpoint (the v2 kernels only;
               img/s and mIoU beside predict_image's on the same images),
               then cli.extract_eval.main, which must list the four IoU
               tables they wrote, each once;
 11. train   — training at full width, random weights from seed 0, no
               hand kernel may launch on any of its train paths:
               train_cls (ClassifierTrainer, VGG16 with BN, VOC 20
               classes, 321^2, batch 8, 10 steps on one synthetic batch,
               dropout on, lr 0.01 constant: img/s, ms a step by CUDA
               events (forward, backward, optimizer), peak memory; the
               losses finite and falling), then one step at batch 2 on the
               card against the CPU from the same weights and dropout
               masks (TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL); train_sec and
               train_dsrg (SECDSRGTrainer, 321^2, batch 8, 21 classes, 10
               steps, synthetic cues as the CLI makes them: img/s, stage
               ms (FCN forward and backward, CRF layer, region grow,
               losses, optimizer), peak memory, grown_px; every loss
               finite); then the training command lines in-process in a
               temporary directory: cli.train_classifier on VOC2012 VGG16
               and ADP-morph X1.7 (16 images, batch 8, 1 epoch, calibration,
               the triplet read back with its thresholds), cli.sec_dsrg
               --task train for SEC and DSRG (1 epoch on 16 images: log
               keys, checkpoint at step 2), then --task predict --method SEC
               from that checkpoint (exactly 44 launches of each v2
               kernel); it stands in for the ROC, .h5 and heatmap writers
               where matplotlib or h5py is missing and says so;
 12. irn     — IRNet (03b), random weights, full width: irn_voc (VGG16,
               4 images of 375x500 with tags: make_cam_batch at the
               scales (1.0, 0.5, 1.5, 2.0), eval_cam_pred, cam_to_ir_label
               at IRN_LABEL with the flat_color_blur launches the CRF
               structures predict and its labels against the plain
               versions, an IRNet vgg16 with the classifier's trunk
               transplanted and edge inference on the 320 top-left crop,
               make_sem_seg at IRN_TUNED (0.5, 8): img/s and peak memory a
               stage, the walk's n, ms, TFLOP/s against its float32 bound
               and its share of make_sem_seg); irn_card_vs_cpu (one 161^2
               image through the chain on the card and on the CPU: cams
               within IRN_CAM_TOL, ir-labels and sem-seg labels at
               IRN_IR_FLOOR / IRN_SEM_FLOOR); irn_train_voc (IRNTrainer
               vgg16 at crop 320, batch 8, radius 10: P 152, M 4402; the
               trunk transplanted from irn_voc's classifier, the heads
               from seed 1; TRAIN_STEPS steps on one synthetic batch whose
               labels come from a flat-block ir-label map with 255
               borders: img/s, ms a step by CUDA events (trunk forward,
               heads forward, to_affinity_sliced + losses, backward,
               optimizer), the host's affinity_labels and host-to-card
               copy apart from the step, peak memory; the trunk bit-equal
               after, the losses finite and falling; no hand kernel);
               irn_train_adp (m7 on an ADP-morph X1.7 classifier of seed
               2 at crop 224: the edge logits' resize and its backward);
               irn_train_card_vs_cpu (vgg16 and m7, batch 2, crop 64:
               calibrate_disp_mean within IRN_DISP_MEAN_TOL, then one step,
               loss within TRAIN_LOSS_RTOL, parameters within
               TRAIN_PARAM_ATOL); cli_irn (cli.irn.main's six passes one at
               a time on 16 synthetic VOC images in a temporary directory,
               make_sem_seg restoring the checkpoint train_irn wrote: img/s
               a pass, no hand kernel but K11 in cam_to_ir_label as
               predicted, eval_sem_seg's mIoU equal to the phase's own
               confusion of the written PNGs; then --passes all, whole);
               irn_adp (one ADP-morph image at its native 1088^2, X1.7:
               make_cam; cam_to_ir_label raises there as the reference's
               does (IRN_LABEL has no tractable structure at that size); an
               IRNet m7 and make_sem_seg at IRN_TUNED (0.5, 1), whose walk
               at n = 73 984 holds two 21.9 GB matrices: its time, TFLOP/s
               and the peak memory);
     parity  — cli.parity.main in its synthetic smoke mode in a temporary
               directory (VOC2012, VGG16 at 321^2, 16 images: 01 -> 02 ->
               03a -> 03b -> 03c; stand-ins for the writers of a missing
               matplotlib or h5py): a report row for each of the five
               methods with its mIoU in [0, 1], the v2 kernels and K11
               launched, the wall time;
     mesh    — the multi-device inference path on Mesh([cuda:0, cuda:0],
               ('data',)), two shards on the one card (times measure
               what banding costs, not scaling): mesh_hsn (the main
               path's segment_batch(mesh=) at batch 8: K1-K3 launched 11
               times a shard, labels against each shard's images on one
               device >= MESH_LABEL_FLOOR, img/s beside one device's;
               then K1-K3 held against their plain versions at a
               shard's B 4, case mesh_hsn_b4_c21);
               mesh_cues (the VOC cue generator over 16 images through
               mesh_batches' prefetch thread: the unsharded cues, no
               hand kernel); mesh_grid (mxu_sharded.mean_field_sharded
               on a seeded 2448^2 image at hsn_config('DeepGlobe'), 2
               bands of 1240 + 2 x 320 rows, K1-K3 on each band, against
               the single-device grid: MESH_GRID_Q_TOL, labels; then
               K1-K3 held against their plain versions on the last
               band's grid at C 5 and C 1 and on the single-device grid,
               cases mesh_grid_c5 / _c1 / _one_c5);
               mesh_window (sharded.mean_field_sharded at 2448^2 at the
               VOC M7 config against the single-device window: |dQ| <=
               MESH_WINDOW_Q_TOL, labels equal; by the cut a soft Q, and
               bands that got no halo far off); mesh_walk
               (propagate_to_edge_sharded on a (2, 1) mesh at n = 11 750
               against propagate_to_edge within MESH_WALK_TOL, ms and
               TFLOP/s, make_sem_seg labels equal); mesh_cli (cli.gen_cues,
               cli.hsn, cli.irn make_cam -> make_sem_seg with --mesh auto
               write the files of --mesh none; cli.train_classifier,
               cli.sec_dsrg --task train and cli.irn --passes train_irn
               with --mesh auto train checkpoints within MESH_CKPT_TOL of
               --mesh none's);
     mesh_train — data-parallel training on the same two-shard mesh
               (the shards' forwards in two host threads on the card):
               mesh_train_cls (ClassifierTrainer, VGG16 with BN, VOC 20
               classes, 321^2, batch 8 as two shards of 4),
               mesh_train_sec and one DSRG step (DeepLab at 321^2, 21
               classes, the CLI's synthetic cues), mesh_train_irn (IRNet
               vgg16, crop 320, radius 10, irn_train_voc's batch): one
               step against one device's from the same weights and
               dropout masks, the loss within TRAIN_LOSS_RTOL and the
               parameter change within MESH_TRAIN_REL of one device's
               (relative, over all parameters; the classifier's held
               step in float64), a half-batch step shown to exceed that
               bound, then img/s and peak memory of MESH_TRAIN_STEPS
               float32 steps beside one device's; no hand kernel;
 13. result  — one JSON line of kernels, then the last line
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


def burst_ms(torch, fn, burst=10, reps=5):
    """Median ms a call over reps replays of one CUDA graph of `burst`
    calls back to back, each replay timed by CUDA events: the device's
    time.  The graph leaves out the host's work a call (Python, ctypes,
    the launch: ~0.03-0.05 ms) that cuda_ms counts and that a burst of
    eager calls still waits on wherever a call's device time is shorter."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        for _ in range(burst):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / burst)
    del graph
    return float(np.median(times))


def bursts(r):
    """The device times of a result, where it has them, for a log line."""
    if 'device_ms' not in r:
        return ''
    lib = (f', library {r["library_device_ms"]:.4f} ms'
           if 'library_device_ms' in r else '')
    return f' (on the device, a graph of 10: {r["device_ms"]:.4f} ms{lib})'


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
    # splat: atomics sum in a run-dependent order -> within 1e-5 of the
    # max; blur and slice use the plain version's operation order with
    # round-to-nearest intrinsics -> held bit-equal
    check(got_s.shape == ref_s.shape and torch.isfinite(got_s).all(),
          f'bilateral_splat {label}: shape {tuple(got_s.shape)} or '
          'non-finite')
    err = float((got_s - ref_s).abs().max())
    scale = float(ref_s.abs().max())
    print(f'[kernels] bilateral_splat {label}: max_abs_err {err:.3e} '
          f'max_rel_err {err / scale:.3e} (tolerance 1e-05 of max |plain| '
          f'{scale:.4g})')
    check(err <= 1e-5 * scale, f'bilateral_splat {label} disagrees with '
          'plain')
    errs = {'bilateral_splat': err}
    for name, got, ref in (('bilateral_color_blur', got_b, ref_b),
                           ('bilateral_slice', got_l, ref_l)):
        errs[name] = hold_bit_equal(torch, name, label, got, ref)
    return errs, ref_s, ref_b, g_sp, ref_l


def v2_cases(torch, K, geo, x, label):
    """hold_v2_kernels on one geometry, then each kernel's time there (a
    call, and on the device) and its bound: ({name: case}, the spatially
    blurred grid and the plain slice, for a yardstick)."""
    errs, ref_s, _, g_sp, ref_l = hold_v2_kernels(torch, K, geo, x, label)
    t, gy, gx, gc, cell = geo.t, geo.gy, geo.gx, geo.gc, geo.cell
    gbytes = ref_s.numel() * 4
    rows4 = torch.cat([r.reshape(-1) for r, _ in
                       K.corner_rows(cell, t, gy, gx, gc ** 3)])
    touched = int(torch.unique(rows4).numel())
    runs = {
        'bilateral_splat': (
            lambda: K.bilateral_splat(x, cell, t, gy, gx, gc),
            bound_ms(x.numel() * 4 + cell.numel() * 4 + gbytes,
                     4 * 3 * x.numel())),
        'bilateral_color_blur': (
            lambda: K.bilateral_color_blur(ref_s, geo.taps),
            bound_ms(2 * gbytes, 3 * 9 * ref_s.numel())),
        'bilateral_slice': (
            lambda: K.bilateral_slice(g_sp, cell, t),
            bound_ms(touched * x.shape[-1] * 4 + cell.numel() * 4
                     + ref_l.numel() * 4, 7 * ref_l.numel()))}
    cases = {}
    for name, (fn, (bb, bf)) in runs.items():
        r = cases[name] = dict(
            max_abs_err=errs[name], ms=cuda_ms(torch, fn),
            device_ms=burst_ms(torch, fn), bound_ms=bb, bound_by=bf)
        print(f'[kernels] {name} {label}: {r["ms"]:.4f} ms{bursts(r)}, '
              f'bound {bb:.4f} ms ({bf})')
    return cases, g_sp, ref_l


def slice_library(torch, K, cell, t, gy, gx, gc, g_sp):
    """One torch.sparse.mm (CSR) that computes the slice: a [pixels,
    grid rows] matrix of the 4 corner weights a pixel, times the grid
    viewed as [rows, C]; returns (the call, the grid rows touched)."""
    corner = K.corner_rows(cell, t, gy, gx, gc ** 3)
    rows4 = torch.cat([r.reshape(-1) for r, _ in corner])
    n_pix = cell.numel()
    s_idx = torch.stack([
        torch.arange(n_pix, device=cell.device).repeat(4), rows4])
    s_val = torch.cat([w.expand(cell.shape).reshape(-1) for _, w in corner])
    with warnings.catch_warnings():     # CSR support is 'beta'
        warnings.simplefilter('ignore', UserWarning)
        smat = torch.sparse_coo_tensor(
            s_idx, s_val, (n_pix, g_sp.numel() // g_sp.shape[-1]),
            check_invariants=False).coalesce().to_sparse_csr()
    g_flat = g_sp.reshape(-1, g_sp.shape[-1])

    def slice_lib():
        return torch.sparse.mm(smat, g_flat)
    return slice_lib, int(torch.unique(rows4).numel())


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
            ms=cuda_ms(torch, splat), device_ms=burst_ms(torch, splat),
            plain_ms=cuda_ms(torch, splat_plain),
            library_ms=cuda_ms(torch, splat_lib), bound_ms=bb, bound_by=bf,
            library_device_ms=burst_ms(torch, splat_lib))

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
            device_ms=burst_ms(torch, lambda: K.bilateral_color_blur(
                ref_s, geo.taps)),
            plain_ms=cuda_ms(torch, lambda: K.bilateral_color_blur_plain(
                ref_s, geo.taps), reps=20),
            library_ms=cuda_ms(torch, blur_lib), bound_ms=bb, bound_by=bf,
            library_device_ms=burst_ms(torch, blur_lib, reps=3))

        slice_lib, touched = slice_library(torch, K, cell, t, gy, gx, gc,
                                           g_sp)
        lib_err = float((slice_lib().view(ref_l.shape) - ref_l).abs().max())
        check(lib_err <= 1e-5 * float(ref_l.abs().max()),
              f'sparse.mm yardstick computes another function ({lib_err})')
        bb, bf = bound_ms(touched * c * 4 + cell.numel() * 4
                          + ref_l.numel() * 4, 7 * ref_l.numel())
        results['bilateral_slice'].update(
            ms=cuda_ms(torch, lambda: K.bilateral_slice(g_sp, cell, t)),
            device_ms=burst_ms(torch, lambda: K.bilateral_slice(g_sp, cell,
                                                                t)),
            plain_ms=cuda_ms(torch, lambda: K.bilateral_slice_plain(
                g_sp, cell, t)),
            library_ms=cuda_ms(torch, slice_lib), bound_ms=bb, bound_by=bf,
            library_device_ms=burst_ms(torch, slice_lib))
    for name, r in results.items():
        print(f'[kernels] {name} C=21: {r["ms"]:.4f} ms{bursts(r)}, plain '
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
        cases, g_sp, ref_l = v2_cases(torch, K, geo, x, label)
        for name, r in cases.items():
            results[name]['cases'][f'sec_v2_c{c}'] = r
        if c == 21:
            # the slice's yardstick at SEC's shape too: it launches the
            # slice twice as often as the main path does
            slice_lib, _ = slice_library(torch, K, cell, t, gy, gx, gc,
                                         g_sp)
            lib_err = float((slice_lib().view(ref_l.shape)
                             - ref_l).abs().max())
            check(lib_err <= 1e-5 * float(ref_l.abs().max()),
                  f'sparse.mm yardstick at SEC\'s shape computes another '
                  f'function ({lib_err})')
            r = cases['bilateral_slice']
            r.update(library_ms=cuda_ms(torch, slice_lib),
                     library_device_ms=burst_ms(torch, slice_lib))
            print(f'[kernels] bilateral_slice {label}: library (sparse.mm) '
                  f'{r["library_ms"]:.4f} ms{bursts(r)}')

    # the v2 route's largest cube: gc 24 (srgb 255/23), C 32; its planes
    # (74 KB) take a plan of channel groups
    gc, c = 24, 32
    check(mxu_grid.v2_eligible(255.0 / (gc - 1), c)
          and not mxu_grid.v2_eligible(255.0 / gc, 1)
          and not mxu_grid.v2_eligible(255.0 / (gc - 1), c + 1),
          'the v2 route\'s largest (gc, C) changed')
    plan = K.color_blur_plan(gc, c)
    check(plan.groups > 1, f'gc {gc} C {c}: plan {plan}')
    grid = torch.rand((2, 3, 3, gc, gc, gc, c), generator=gen, device=dev)
    label = (f'B=2 3x3 nodes gc={gc} C={c} (channel groups '
             f'{plan.channel_groups()})')
    err = hold_bit_equal(torch, 'bilateral_color_blur', label,
                         K.bilateral_color_blur(grid, geo.taps),
                         K.bilateral_color_blur_plain(grid, geo.taps))
    ms = cuda_ms(torch, lambda: K.bilateral_color_blur(grid, geo.taps))
    bb, bf = bound_ms(2 * grid.numel() * 4, 3 * 9 * grid.numel())
    results['bilateral_color_blur']['cases']['v2_largest'] = dict(
        max_abs_err=err, ms=ms, bound_ms=bb, bound_by=bf)
    print(f'[kernels] bilateral_color_blur {label}: {ms:.4f} ms, bound '
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
        device_ms=burst_ms(torch, lambda: K.bilateral_splat_tiles(
            x, cell, t, gc)),
        plain_ms=cuda_ms(torch, lambda: K.bilateral_splat_tiles_plain(
            x, cell, t, gc), reps=5, warmup=1),
        library_ms=cuda_ms(torch, tiles_lib),
        library_device_ms=burst_ms(torch, tiles_lib), bound_ms=bb,
        bound_by=bf)
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
        device_ms=burst_ms(torch, lambda: K.bilateral_fold(part)),
        plain_ms=cuda_ms(torch, lambda: K.bilateral_fold_plain(part),
                         reps=10),
        library_ms=cuda_ms(torch, fold_lib, reps=10), bound_ms=bb,
        bound_by=bf, library_device_ms=burst_ms(torch, fold_lib, reps=3))
    del cols
    # fold + blur is two PyTorch calls (F.fold, conv3d): no single one
    bb, bf = bound_ms(pbytes + gbytes, (3 + 27) * fold.numel())
    res['bilateral_fold_blur'].update(
        ms=cuda_ms(torch, lambda: K.bilateral_fold_blur(part, taps)),
        device_ms=burst_ms(torch, lambda: K.bilateral_fold_blur(part, taps)),
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
        device_ms=burst_ms(torch, lambda: K.bilateral_cube_blur(fold, taps)),
        plain_ms=cuda_ms(torch, lambda: K.bilateral_cube_blur_plain(
            fold, taps), reps=10),
        library_ms=cuda_ms(torch, blur_lib, reps=5, warmup=1),
        bound_ms=bb, bound_by=bf,
        library_device_ms=burst_ms(torch, blur_lib, reps=3),
        color_blur_ms=cuda_ms(
            torch, lambda: K.bilateral_color_blur(fold, taps)))
    rows4 = torch.cat([r.reshape(-1) for r, _ in
                       K.corner_rows(cell, t, gy, gx, gc3)])
    bb, bf = bound_ms(int(torch.unique(rows4).numel()) * c * 4
                      + cell.numel() * 4 + sliced.numel() * 4,
                      7 * sliced.numel())
    res['bilateral_slice'].update(
        ms=cuda_ms(torch, lambda: K.bilateral_slice(g_sp, cell, t)),
        device_ms=burst_ms(torch, lambda: K.bilateral_slice(g_sp, cell, t)),
        bound_ms=bb, bound_by=bf)
    for name, r in res.items():
        lib = ('not timed' if 'library_ms' not in r
               else 'no single call' if r['library_ms'] is None
               else f'{r["library_ms"]:.4f} ms')
        plain = (f'{r["plain_ms"]:.4f} ms' if 'plain_ms' in r
                 else 'not timed')
        print(f'[kernels] {name} {label}: {r["ms"]:.4f} ms{bursts(r)}, '
              f'plain {plain}, library {lib}, bound {r["bound_ms"]:.4f} ms '
              f'({r["bound_by"]})')
    print(f'[kernels] colour blur {label} ({gbytes / 1e6:.0f} MB): '
          f'bilateral_color_blur '
          f'{res["bilateral_cube_blur"]["color_blur_ms"]:.4f} ms against '
          f'bilateral_cube_blur {res["bilateral_cube_blur"]["ms"]:.4f} ms')
    return res


# (geometry, message channels, case prefix); the batch-8 cases are an
# extra that no path of this script runs on the v1 route
V1_CASES = (('sec', 21, 'sec'), ('wide', 40, 'wide'),
            ('hsn', 21, 'b8'), ('hsn', 40, 'b8'))
# the slice's and the fold's device times in their previous design (a
# thread an element: this script on an H100 80GB HBM3 at 700 W, a graph of
# 10 calls), for the log; scripts/time_tile_kernels.py --tree times two
# checkouts in one run
PARENT_DEVICE_MS = {'bilateral_slice/hsn_c21': '0.0079-0.0081',
                    'bilateral_slice/sec_v2_c21': '0.0025-0.0027',
                    'bilateral_slice/sec_c21': '0.0025-0.0028',
                    'bilateral_slice/wide_c40': '0.0028-0.0029',
                    'bilateral_fold/sec_c21': '0.0411-0.0413',
                    'bilateral_fold/wide_c40': '0.0741-0.0750',
                    'bilateral_fold/b8_c21': '0.5427-0.5431'}
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

    # the v1 route's finest cube on the paths' guides: srgb 5 -> gc 52, a
    # cg row past the register row phase's 24 cells
    big = mxu_grid.MXUBilateralGrid(guide[:1], 8.0, 5.0, 1)
    plan = K.cube_blur_plan(big.gc, 1, 1, big.gy * big.gx)
    check(big.gc == 52 and not big.v2 and not big.fuse_combine_blur
          and not plan.reg_rows, f'large-cube case changed: gc {big.gc}')
    ones = torch.ones((1, GUIDE, GUIDE, 1), device=dev)
    part = K.bilateral_splat_tiles(ones, big.cell, big.t, big.gc)
    check(torch.equal(part, K.bilateral_splat_tiles_plain(
        ones, big.cell, big.t, big.gc)),
        'bilateral_splat_tiles gc=52 C=1 is not bit-equal to its plain '
        'version')
    grid = K.bilateral_fold(part)
    hold_bit_equal(torch, 'bilateral_fold_blur', 'gc=52 C=1 B=1',
                   K.bilateral_fold_blur(part, big.taps),
                   K.bilateral_fold_blur_plain(part, big.taps))
    hold_bit_equal(torch, 'bilateral_cube_blur', 'gc=52 C=1 B=1',
                   K.bilateral_cube_blur(grid, big.taps),
                   K.bilateral_cube_blur_plain(grid, big.taps))
    del part
    ms = cuda_ms(torch, lambda: K.bilateral_cube_blur(grid, big.taps))
    dms = burst_ms(torch, lambda: K.bilateral_cube_blur(grid, big.taps))
    bb, _ = bound_ms(2 * grid.numel() * 4, 27 * grid.numel())
    print(f'[kernels] bilateral_splat_tiles, bilateral_fold_blur and '
          f'bilateral_cube_blur gc=52 C=1 B=1 ({plan.slabs} cr slabs of '
          f'{plan.nl} planes a node): bit-equal; cube blur {ms:.4f} ms, on '
          f'the device {dms:.4f} ms, bound {bb:.4f} ms')
    results['bilateral_cube_blur']['gc52_ms'] = ms
    results['bilateral_cube_blur']['cases']['gc52_c1'] = dict(
        ms=ms, device_ms=dms, bound_ms=bb, bound_by='bytes')


def fixed_costs(torch, results):
    """The slice's and the fold's device time on a one-run input (the
    slice: B 1, an 8x8 guide, t 8, gc 16, C 1; the fold: one 1x1-tile
    partial, gc 16, C 1), each held bit-equal: how much of a kernel's time
    is the launch itself.  Then each case's device time beside the
    previous design's."""
    from wsss_tpu_torch.kernels import bilateral as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(8)
    grid = torch.rand((1, 2, 2, 16, 16, 16, 1), generator=gen, device=dev)
    cell = torch.randint(0, 16 ** 3, (1, 8, 8), generator=gen, device=dev,
                         dtype=torch.int32)
    part = torch.rand((1, 1, 1, 4, 16, 16, 16, 1), generator=gen, device=dev)
    for name, fn, plain in (
            ('bilateral_slice', lambda: K.bilateral_slice(grid, cell, 8),
             lambda: K.bilateral_slice_plain(grid, cell, 8)),
            ('bilateral_fold', lambda: K.bilateral_fold(part),
             lambda: K.bilateral_fold_plain(part))):
        hold_bit_equal(torch, name, 'one-run input', fn(), plain())
        r = results[name]
        r['fixed_ms'] = burst_ms(torch, fn)
        print(f'[kernels] {name} fixed cost (one-run input, on the device):'
              f' {r["fixed_ms"]:.4f} ms')
        cases = dict(r['cases'], **{r['shape']: r})
        for case, c in cases.items():
            parent = PARENT_DEVICE_MS.get(f'{name}/{case}')
            if 'device_ms' in c and parent:
                print(f'[kernels] {name} {case}: {c["device_ms"]:.4f} ms on '
                      f'the device (fixed cost {r["fixed_ms"]:.4f}, bound '
                      f'{c["bound_ms"]:.4f}); the previous design {parent}')


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
    # one launch a filter: a C 1 normalizer and one message a mean-field
    # iteration
    want = n_batches * (seg.cfg.iterations + 1)
    check(launches['bilateral_color_blur'] == want,
          f'bilateral_color_blur launched {launches["bilateral_color_blur"]}'
          f' times on the main path, expected {want}')

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


def bf16_handles(gc, model_type, n, size, seeds):
    """Handles built as WSSS_TPU_BF16_INFER=1 builds them (read at the
    build by infer_dtype), with the f32 handles' seeds."""
    import os
    import torch
    os.environ['WSSS_TPU_BF16_INFER'] = '1'
    try:
        hs = [gc._ClassifierHandle.random(model_type, n, size, seed=s)
              for s in seeds]
    finally:
        del os.environ['WSSS_TPU_BF16_INFER']
    check(all(h.model.dtype == torch.bfloat16 for h in hs),
          'WSSS_TPU_BF16_INFER did not build bf16 classifiers')
    return hs


def cue_agreement(a, b, n_classes, indices):
    """(fraction of images with equal '_labels', lowest per-image share of
    the 41x41 seed pixels whose one-hot cue vectors are equal)."""
    from wsss_tpu_torch.io import artifacts
    labels, worst = 0, 1.0
    for i in indices:
        labels += int(np.array_equal(a[f'{i}_labels'], b[f'{i}_labels']))
        da = artifacts.unpack_cues(a, int(i), (41, 41, n_classes))
        db = artifacts.unpack_cues(b, int(i), (41, 41, n_classes))
        worst = min(worst, float(np.all(da == db, axis=-1).mean()))
    return labels / len(indices), worst


def timed_run(torch, gen, batches):
    """(pickle dicts, img/s): gen.run over host batches, host clock ending
    in a synchronize, after a warm-up batch."""
    from wsss_tpu_torch.kernels import bilateral as K
    gen.run(batches[:1])
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = gen.run(batches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = sum(len(b.indices) for b in batches)
    return out, n / dt, dict(K.LAUNCHES)


def phase_cues(torch):
    """Grad-CAM cue generation (the 02_cues stage) at full width: VOC2012
    VGG16 fg + bg at 321^2 and ADP X1.7 at 224^2, f32 and bf16, and one
    VOC batch of 2 on the card against the CPU."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.methods import gradcam_cues as gc
    spec = registry.get('VOC2012')
    n_fg, n_seg = spec.n_fg_classes, spec.n_seg_classes
    n_img = 16
    batches = list(SyntheticWSSS('VOC2012', size=SIZE,
                                 n_images=n_img).batches(BATCH))
    t0 = time.perf_counter()
    fg, bg = (gc._ClassifierHandle.random('VGG16', n_fg, SIZE, seed=s)
              for s in (0, 1))
    gen = gc.VOCDeepGlobeCueGenerator(spec, fg, bg)
    torch.cuda.synchronize()
    print(f'[cues] VGG16 fg + bg handles built in '
          f'{time.perf_counter() - t0:.2f} s')
    out, ips, voc_launches = timed_run(torch, gen, batches)
    print(f'[cues] VOC2012 VGG16 fg + bg, {n_img} images at {SIZE}^2 in '
          f'batches of {BATCH}: {ips:.2f} img/s; launches {voc_launches}')
    check_launches(voc_launches, (), 'the cues path (no hand kernel: cue '
                   'generation is plain PyTorch, as in the reference)')
    check(set(out) == {f'{i}_{k}' for i in range(n_img)
                       for k in ('labels', 'cues')}, 'cue pickle keys')
    per_class = np.zeros(n_seg, np.int64)
    for i in range(n_img):
        sp = out[f'{i}_cues']
        check(sp.ndim == 2 and sp.shape[0] == 3 and
              (sp.size == 0 or (sp[0].max() < n_seg and sp[1:].max() < 41)),
              f'cues of image {i} out of the seed grid')
        check(np.all(out[f'{i}_labels'] >= 1), 'VOC labels must be >= 1')
        per_class += np.bincount(sp[0], minlength=n_seg)
    print(f'[cues] cue pixels per class over the {n_img} images: '
          f'{per_class.tolist()}')
    b0 = batches[0]
    x = torch.as_tensor(b0.images, device='cuda')
    tags = torch.as_tensor(b0.tags, device='cuda')
    cam_ms = cuda_ms(torch, lambda: gen.generate_batch(x, tags), reps=5,
                     warmup=1)
    print(f'[cues] CAM-to-cues ms per batch of {BATCH} (generate_batch, both '
          f'nets): {cam_ms:.2f}')

    # card against CPU on one batch of 2 (same seeds, float32, TF32 off).
    # Random weights put every score near 0.5: at the 0.5 default a pass
    # flag (of either net: the bg net's masks its CAMs too) could flip on
    # the two devices' float noise, so both sides take per class the
    # middle of the widest gap between 0, 1 and the card's two scores
    # (each score at least 1/6 from it; both branches taken)
    sub = [first_images(b0, 2)]
    ths, margin_05, n_pass = [], 1.0, 0
    for h in (fg, bg):
        with torch.no_grad():
            scores = h.model(gen._norm(x[:2]))[0].cpu().numpy()
        ths.append(separating_thresholds(scores))
        h.thresholds = torch.as_tensor(ths[-1], device='cuda')
        margin_05 = min(margin_05, float(np.abs(scores - 0.5).min()))
        n_pass += int((scores >= ths[-1]).sum())
    on_card = gen.run(sub)
    cpu_h = [gc._ClassifierHandle.random('VGG16', n_fg, SIZE, seed=s,
                                         thresholds=th, device='cpu')
             for s, th in zip((0, 1), ths)]
    on_cpu = gc.VOCDeepGlobeCueGenerator(spec, *cpu_h, device='cpu').run(sub)
    lab, agree = cue_agreement(on_card, on_cpu, n_seg, range(2))
    print(f'[cues] card vs CPU, one batch of 2: labels equal on {lab:.3f} '
          f'of the images, cue agreement {agree:.6f} of the seed pixels '
          f'(tolerance 0.999; passing scores {n_pass} of {2 * 2 * n_fg}; '
          f'nearest score to 0.5 {margin_05:.3e})')
    check(lab == 1.0, 'cue labels differ between the card and the CPU')
    check(agree >= 0.999, f'card vs CPU cue agreement {agree} < 0.999')

    adp_batches = list(SyntheticWSSS('ADP-morph', size=224,
                                     n_images=n_img).batches(BATCH))
    adp = gc.ADPCueGenerator(
        gc._ClassifierHandle.random('X1.7', 51, 224, seed=2), 'X1.7')
    (adp_m, adp_f), adp_ips, launches = timed_run(torch, adp, adp_batches)
    print(f'[cues] ADP X1.7, {n_img} images at 224^2 in batches of {BATCH}: '
          f'{adp_ips:.2f} img/s; launches {launches}')
    check_launches(launches, (), 'the ADP cues path')
    check(all(1 in adp_f[f'{i}_labels'] for i in range(n_img)),
          "ADP func labels must hold 'Other'")

    fg16, bg16 = bf16_handles(gc, 'VGG16', n_fg, SIZE, (0, 1))
    out16, ips16, launches = timed_run(
        torch, gc.VOCDeepGlobeCueGenerator(spec, fg16, bg16), batches)
    check_launches(launches, (), 'the bf16 cues path')
    lab, agree = cue_agreement(out16, out, n_seg, range(n_img))
    print(f'[cues] bf16 classifiers (WSSS_TPU_BF16_INFER=1): VOC '
          f'{ips16:.2f} img/s against f32 {ips:.2f}; labels equal on '
          f'{lab:.3f} of the images, lowest cue agreement with f32 '
          f'{agree:.6f}')
    (adp16_m, adp16_f), adp16_ips, _ = timed_run(torch, gc.ADPCueGenerator(
        bf16_handles(gc, 'X1.7', 51, 224, (2,))[0], 'X1.7'), adp_batches)
    lab_m, agree_m = cue_agreement(adp16_m, adp_m, 29, range(n_img))
    lab_f, agree_f = cue_agreement(adp16_f, adp_f, 5, range(n_img))
    print(f'[cues] bf16 ADP X1.7: {adp16_ips:.2f} img/s against f32 '
          f'{adp_ips:.2f}; labels equal on {lab_m:.3f} (morph) / '
          f'{lab_f:.3f} (func) of the images, lowest cue agreement with '
          f'f32 {agree_m:.6f} / {agree_f:.6f}')
    return {'cues': voc_launches}


def separating_thresholds(scores):
    """Per class, the middle of the widest gap between 0, 1 and the
    class's scores [B, C]."""
    th = []
    for col in scores.T:
        v = np.sort(np.concatenate([[0.0, 1.0], col]))
        k = int(np.argmax(np.diff(v)))
        th.append((v[k] + v[k + 1]) / 2)
    return np.asarray(th, np.float32)


def first_images(batch, n):
    """The first n images of a host batch."""
    import dataclasses
    return dataclasses.replace(
        batch, indices=batch.indices[:n], names=batch.names[:n],
        images=batch.images[:n], tags=batch.tags[:n],
        gt=None if batch.gt is None else batch.gt[:n])


# per bf16 mode: (least label and posterior-argmax agreement with the
# float32 run, largest mean |dQ| of the CRF posterior), about 3x the
# disagreement and the mean |dQ| read on an H100 80GB HBM3 at 700 W:
# 0.995832 / 4.35e-4 (classifiers), 0.999794 / 2.65e-5 (CRF state),
# 0.995936 / 4.35e-4 (both).  A loop that drops a message moves mean
# |dQ| far past rounding.  max |dQ| is printed, not bounded: near-tied
# pixels that flip label give it ~1 under rounding alone.
PRECISION_BOUNDS = {'bf16_classifiers': (0.987, 1.3e-3),
                    'bf16_crf_state': (0.9994, 8e-5),
                    'bf16_both': (0.987, 1.3e-3)}


def phase_precision(torch, main_launches):
    """The main path in the reference's two bf16 opt-ins and both: bf16
    classifiers (WSSS_TPU_BF16_INFER), the bf16 CRF state
    (meanfield._CRF_STATE_BF16, which the reference's bench flips the same
    way), against the float32 run on the same batch."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods import gradcam_cues as gc
    from wsss_tpu_torch.methods.hsn import HSNSegmenter
    from wsss_tpu_torch.ops.crf import meanfield as mf
    spec = registry.get('VOC2012')
    n_fg = spec.n_fg_classes
    f32 = [gc._ClassifierHandle.random('VGG16', n_fg, SIZE, seed=s)
           for s in (0, 1)]
    b16 = bf16_handles(gc, 'VGG16', n_fg, SIZE, (0, 1))
    gen = torch.Generator(device='cuda').manual_seed(1)
    batches = [torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                             dtype=torch.uint8, generator=gen,
                             device='cuda') for _ in range(2)]
    seg32 = HSNSegmenter(spec, *f32, model_type='VGG16')
    want = seg32.segment_batch(batches[0])
    check(mf._CRF_STATE_BF16 is False, 'the bf16 CRF state is on by default')
    imgs = batches[0].to(torch.float32)
    probs32 = seg32.probs(imgs)
    q32 = mf.mean_field(probs32, imgs, seg32.cfg)
    paths = {}
    for mode, handles, state in (('bf16_classifiers', b16, False),
                                 ('bf16_crf_state', f32, True),
                                 ('bf16_both', b16, True)):
        seg = HSNSegmenter(spec, *handles, model_type='VGG16')
        mf._CRF_STATE_BF16 = state
        try:
            seg.segment_batch(batches[0])                 # warm-up
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            labels = [seg.segment_batch(b) for b in batches]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            cam_ms = cuda_ms(torch, lambda: seg.probs(imgs), reps=5,
                             warmup=1)
            probs = seg.probs(imgs)
            crf_ms = cuda_ms(torch, lambda: mf.mean_field(probs, imgs,
                                                          seg.cfg),
                             reps=5, warmup=1)
            q = mf.mean_field(probs, imgs, seg.cfg)
        finally:
            mf._CRF_STATE_BF16 = False
        check_launches(launches, V2_KERNELS, f'the {mode} main path')
        check(launches == main_launches,
              f'{mode} launches {launches} differ from the main path\'s '
              f'{main_launches}')
        agree = float((labels[0] == want).float().mean())
        dq = (q - q32).abs()
        dq_max, dq_mean = float(dq.max()), float(dq.mean())
        q_agree = float((q.argmax(-1) == q32.argmax(-1)).float().mean())
        min_agree, max_dq = PRECISION_BOUNDS[mode]
        print(f'[precision] {mode}: {2 * BATCH / dt:.2f} img/s '
              f'({1e3 * dt / 2:.2f} ms/batch), CAM {cam_ms:.2f} ms, CRF '
              f'{crf_ms:.2f} ms per batch of {BATCH}; label agreement with '
              f'the f32 run on the same batch {agree:.6f} (fails below '
              f'{min_agree}); the CRF posterior against the f32 one: '
              f'max |dQ| {dq_max:.4e}, mean |dQ| {dq_mean:.4e} (fails '
              f'above {max_dq:.1e} or at 0), argmax agreement '
              f'{q_agree:.6f}; launches {launches}')
        check(labels[0].shape == want.shape and agree >= min_agree,
              f'{mode} labels agree {agree} < {min_agree} with f32')
        check(q.shape == q32.shape and 0 < dq_mean <= max_dq
              and q_agree >= min_agree,
              f'{mode} posterior: mean |dQ| {dq_mean} (0 < . <= {max_dq}), '
              f'argmax agreement {q_agree} (>= {min_agree}) with f32')
        paths[f'precision_{mode}'] = launches
    return paths


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
    want = len(images) * (cfg.iterations + 1)           # one a filter
    check(launches_v2['bilateral_color_blur'] == want,
          f'bilateral_color_blur launched '
          f'{launches_v2["bilateral_color_blur"]} times on the SEC default '
          f'route, expected {want}')
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
        check(launches_v1['bilateral_fold_blur'] == want,
              f'bilateral_fold_blur launched '
              f'{launches_v1["bilateral_fold_blur"]} times on the SEC v1 '
              f'route, expected {want}')
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
    # the C 1 normalizer on the fused route, one message a iteration on
    # the unfused one
    check(launches['bilateral_fold_blur'] == 1
          and launches['bilateral_cube_blur'] == cfg.iterations,
          f'cube blurs on the wide path: {launches}')
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
    # one launch for the fused form's three passes, two for the split
    # form's (2 passes on per-gr stripes, then 1)
    check(K.LAUNCHES['flat_color_blur'] == (1 + 2 if want_form == 'split'
                                            else 1 + 1),
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
            r['device_ms'] = burst_ms(torch, fns[name], burst=5, reps=3)
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
        burst = (f' ({r["device_ms"]:.4f} ms on the device, a graph of 5)'
                 if 'device_ms' in r else '')
        print(f'[kernels] {name} {label}: {r["ms"]:.4f} ms{burst}{extra}, '
              f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]})')
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
        if case == 'b8_gc16':
            # the aligned filter's cube blur, on the splatted grid
            label_c = f'aligned {label}'
            err = hold_bit_equal(
                torch, 'bilateral_cube_blur', label_c,
                K.bilateral_cube_blur(ref_s, geo.taps),
                K.bilateral_cube_blur_plain(ref_s, geo.taps))
            bb, bf = bound_ms(2 * ref_s.numel() * 4, 27 * ref_s.numel())
            r = results['bilateral_cube_blur']['cases']['aligned_b8'] = dict(
                max_abs_err=err,
                ms=cuda_ms(torch, lambda: K.bilateral_cube_blur(
                    ref_s, geo.taps)),
                device_ms=burst_ms(torch, lambda: K.bilateral_cube_blur(
                    ref_s, geo.taps)), bound_ms=bb, bound_by=bf)
            print(f'[kernels] bilateral_cube_blur {label_c}: {r["ms"]:.4f} '
                  f'ms{bursts(r)}, bound {bb:.4f} ms ({bf})')
            torch.cuda.empty_cache()
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
                device_ms=burst_ms(torch, lambda: K.bilateral_splat_aligned(
                    x, cell, t, gc)),
                plain_ms=cuda_ms(torch, lambda:
                                 K.bilateral_splat_aligned_plain(
                                     x, cell, t, gc), reps=10),
                library_ms=cuda_ms(torch, splat_lib, reps=10),
                bound_ms=bb, bound_by=bf,
                library_device_ms=burst_ms(torch, splat_lib))
            touched = int(torch.unique(flat_rows).numel())
            bb, bf = bound_ms(touched * c * 4 + cell.numel() * 4
                              + ref_l.numel() * 4, 0)
            res['bilateral_slice_aligned'].update(
                ms=cuda_ms(torch, lambda: K.bilateral_slice_aligned(
                    g_bl, cell, t)),
                device_ms=burst_ms(torch, lambda: K.bilateral_slice_aligned(
                    g_bl, cell, t)),
                plain_ms=cuda_ms(torch, lambda:
                                 K.bilateral_slice_aligned_plain(
                                     g_bl, cell, t), reps=10),
                library_ms=cuda_ms(torch, lambda: g_flat[rows], reps=10),
                library_device_ms=burst_ms(torch, lambda: g_flat[rows]),
                bound_ms=bb, bound_by=bf)
            for name, r in res.items():
                print(f'[kernels] {name} {label}: {r["ms"]:.4f} ms'
                      f'{bursts(r)}, plain {r["plain_ms"]:.4f} ms, library '
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
    want = (cfg.iterations + 1) * n_img                 # one a filter
    check(launches['flat_color_blur'] == want and n_split == 4,
          f'flat_color_blur launches {launches["flat_color_blur"]} from '
          f'crf_label_refine and {n_split} from blur_color_axes, expected '
          f'{want} and 4')
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


def window_guides(torch, b, h, w, gen):
    """Guides [B, H, W, 3] of flat-coloured 4-px blocks plus noise 3:
    neighbours close in colour, so ADP's srgb 4 weights are not all ~0."""
    blocks = torch.randint(40, 250, (b, -(-h // 4), -(-w // 4), 3),
                           generator=gen, device='cuda').float()
    img = blocks.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :h, :w]
    img = img + 3 * torch.randn(img.shape, generator=gen, device='cuda')
    return img.clamp(0, 255).contiguous()


def added_mib(torch, fn):
    """Device memory fn() adds at its peak beyond what is allocated."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


# FLOPs of one colour weight: 3 differences, 3 squares and sums, the
# scale, exp, the spatial weight
COLOUR_WEIGHT_FLOPS = 11


def hold_direct_window(torch, imgs, cfg, x, label):
    """DirectBilateral.filter (the direct_window kernel, one launch)
    against its plain version and against the same window summed offset
    by offset from weight maps computed one at a time (the reference's
    cached form: the maps are kept, every filter shifts x once per
    offset), each within 1e-4 of the largest magnitude; in time against
    its bound, the plain version and the cached form, and in the device
    memory a filter adds.  The bound counts 2 C FLOPs an offset and
    pixel and half a colour weight's 11 (w(p, p+o) = w(p+o, p): the
    least a filter that computes its weights anew has to do) at the
    float32 peak, or the guide and x read once and the sum written once
    at HBM's rate, whichever is larger.  Returns the number of offsets
    and the kernel's result (its error from the plain version, times,
    bound, memory)."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import meanfield as mf
    win = mf.DirectBilateral(imgs, cfg.bi_sxy, cfg.bi_srgb)
    before = K.LAUNCHES['direct_window']
    got = win.filter(x)
    check(K.LAUNCHES['direct_window'] == before + 1,
          f'direct window {label}: not one direct_window launch')
    b, h, w, c = x.shape
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
    cache_mib = cache.numel() * 4 / 2 ** 20

    def cached_filter():
        out = torch.zeros_like(x)
        for i, (dy, dx) in enumerate(win.offs):
            out = out + cache[i][..., None] * mf._shift2d(x, dy, dx)
        return out
    ref = cached_filter()
    rel = float((got - ref).abs().max() / ref.abs().max())
    ms_c = cuda_ms(torch, cached_filter, reps=3, warmup=1)
    del cache
    with K.plain_versions():
        plain = win.filter(x)
        ms_p = cuda_ms(torch, lambda: win.filter(x), reps=3, warmup=1)
        peak_p = added_mib(torch, lambda: win.filter(x))
    rel_plain = float((got - plain).abs().max() / plain.abs().max())
    ms = cuda_ms(torch, lambda: win.filter(x), reps=10, warmup=2)
    peak = added_mib(torch, lambda: win.filter(x))
    pairs = len(win.offs) * b * h * w
    bound, by = bound_ms(4 * b * h * w * (3 + 2 * c),
                         (2 * c + COLOUR_WEIGHT_FLOPS / 2) * pairs)
    plan = K.direct_window_plan(b, h, w, c, win._table.rx)
    print(f'[adp_hsn] DirectBilateral {label}, sxy {cfg.bi_sxy:.4g} srgb '
          f'{cfg.bi_srgb:.4g}, {len(win.offs)} offsets, plan g {plan.g} '
          f'p {plan.p}: max rel diff from the plain version '
          f'{rel_plain:.3e}, from the offset-by-offset sum {rel:.3e} '
          f'(tolerance 1e-4); direct_window {ms:.3f} ms a filter (bound '
          f'{bound:.3f} ms by {by}, {bound / ms:.3f} of it) against '
          f'{ms_p:.2f} ms for the plain version and {ms_c:.2f} ms from '
          f'cached weight maps ({cache_mib:.0f} MiB, built in '
          f'{build_ms:.1f} ms); a filter adds {peak:.1f} MiB at its peak '
          f'(plain {peak_p:.1f})')
    check(torch.isfinite(got).all() and rel <= 1e-4 and rel_plain <= 1e-4,
          f'direct window {label} disagrees with its plain version or the '
          'offset-by-offset sum')
    return len(win.offs), dict(
        max_abs_err=float((got - plain).abs().max()), ms=ms, plain_ms=ms_p,
        library_ms=None, bound_ms=bound, bound_by=by,
        cached_maps_ms=ms_c, peak_mib=peak, plain_peak_mib=peak_p,
        plan=dict(g=plan.g, p=plan.p, grid=list(plan.grid)))


def phase_adp_hsn(torch, results):
    """ADPHSNSegmenter at full width on the direct window; the window's
    kernel held at every shape the path gives it and at the VOC M7
    config's (results['direct_window'], its row keyed to the morph CRF's
    iterations, C 29)."""
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
    check_launches(launches, ('direct_window',), 'the adp_hsn path')
    check(launches['direct_window'] == 2 * (seg.cfg_morph.iterations + 1),
          f'adp_hsn: {launches["direct_window"]} direct_window launches, '
          'expected one a filter')
    for lab, spec in ((lab_m, seg.morph_spec), (lab_f, seg.func_spec)):
        check(lab.shape == (BATCH, size, size) and lab.dtype == torch.int32
              and int(lab.min()) >= 0
              and int(lab.max()) < spec.n_seg_classes,
              f'{spec.name} labels out of shape or range')
        print(f'[adp_hsn] {spec.name}: '
              f'{int(lab.unique().numel())} labels present')
    # every shape the path gives the kernel: each CRF's normalizer (C 1)
    # and its iterations (C its classes), batch 8 at 224^2, on its config
    guides = window_guides(torch, BATCH, size, size, gen)
    cases = {}
    for name, spec, cfg in (('morph', seg.morph_spec, seg.cfg_morph),
                            ('func', seg.func_spec, seg.cfg_func)):
        for c in (1, spec.n_seg_classes):
            x = torch.rand((BATCH, size, size, c), generator=gen,
                           device='cuda')
            n_off, cases[f'adp_{name}_b{BATCH}_c{c}'] = hold_direct_window(
                torch, guides, cfg, x, f'ADP {name}, B {BATCH} C {c}')
            check(n_off > 2800, f'ADP window has {n_off} offsets')
    morph = f'adp_morph_b{BATCH}_c{seg.morph_spec.n_seg_classes}'
    # the VOC M7 HistoSegNet config: a small window (81 offsets)
    from wsss_tpu_torch.ops.crf import config as crf_config
    cfg = crf_config.hsn_config('VOC2012', 'M7')
    check(mf.bilateral_structure((size, size), cfg.bi_sxy, cfg.bi_srgb)
          == 'direct', f'{cfg} no longer routes to the direct window')
    x = torch.rand((BATCH, size, size, 21), generator=gen, device='cuda')
    _, cases[f'voc_m7_b{BATCH}_c21'] = hold_direct_window(
        torch, guides, cfg, x, f'VOC M7, B {BATCH} C 21')
    results['direct_window'] = dict(cases[morph], shape=morph, cases=cases)
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


# The cli phase holds the CLI's mIoU to the one the phase computes from
# segment_batch / predict_image on the same images: the v2 splat adds in
# f32 atomics, in another order each run, so near-tied pixels may flip
# between two runs (the main phase holds labels at >= 0.999 against the
# plain versions; every run so far read 1.000000).  A flipped pixel moves
# the IoU of the two classes it leaves and joins by about 1/union.
CLI_MIOU_TOL = 1e-3
CLI_LABEL_FLOOR = 0.999


def run_cli(torch, main, argv):
    """(result, stdout, seconds, launches) of one in-process CLI call: the
    launch counts set to 0 just before, read just after; the host clock
    ends in a synchronize."""
    import contextlib
    import io
    from wsss_tpu_torch.kernels import bilateral as K
    out = io.StringIO()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            res = main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        print(''.join(f'  | {line}\n'
                      for line in out.getvalue().splitlines()), end='')
    return res, out.getvalue(), dt, dict(K.LAUNCHES)


class MissingWriters:
    """While installed, stand-ins for the writers whose library this
    machine lacks (matplotlib: the ROC plot and the confusion heatmap;
    h5py: the Keras .h5): each prints which file it did not write."""

    def __init__(self, tag):
        import importlib.util
        from wsss_tpu_torch.eval import reports
        from wsss_tpu_torch.io import legacy
        self.tag = tag
        self.swaps = [(mod, name, lib) for mod, name, lib in (
            (reports, 'plot_rocs', 'matplotlib'),
            (reports, 'confusion_heatmap', 'matplotlib'),
            (legacy, 'write_keras_h5', 'h5py'))
            if importlib.util.find_spec(lib) is None]

    def stand_in(self, name, lib):
        import os

        def skip(path, *a, **kw):
            print(f'[{self.tag}] {os.path.basename(path)} not written: '
                  f'{lib} is not installed on this machine ({name})')
        return skip

    def __enter__(self):
        self.kept = [getattr(mod, name) for mod, name, _ in self.swaps]
        for mod, name, lib in self.swaps:
            setattr(mod, name, self.stand_in(name, lib))
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.swaps, self.kept):
            setattr(mod, name, fn)


def csv_and_xlsx_agree(csv_path):
    """The IoU csv and its .xlsx sibling: same class rows, values within
    the csv's 5 decimals."""
    import csv
    import os
    from wsss_tpu_torch.eval import xlsx
    xlsx_path = os.path.splitext(csv_path)[0] + '.xlsx'
    check(os.path.isfile(csv_path) and os.path.isfile(xlsx_path),
          f'{csv_path} or its .xlsx sibling was not written')
    with open(csv_path) as f:
        rows = list(csv.reader(f))[1:]
    table = xlsx.read_table_xlsx(xlsx_path)
    check([r[0] for r in rows[:-1]] + ['Mean'] == table['Class']
          and rows[-1][0] == 'miou', f'{xlsx_path} rows differ from the csv')
    err = max(abs(float(r[1]) - v) for r, v in zip(rows, table['IoU']))
    check(err <= 5e-6, f'{xlsx_path} values differ from the csv by {err}')


def labels_from_pngs(out_dir, names, palette):
    """Labels [N, H, W] read back from the CLI's colour PNGs through the
    palette (-1 where a colour is not in it)."""
    import os
    from PIL import Image
    weights = np.array([65536, 256, 1])
    codes = palette.astype(np.int64) @ weights
    order = np.argsort(codes)
    out = []
    for name in names:
        rgb = np.asarray(Image.open(os.path.join(out_dir, name + '.png')),
                         np.int64) @ weights
        at = np.clip(np.searchsorted(codes[order], rgb), 0, len(codes) - 1)
        out.append(np.where(codes[order][at] == rgb, order[at], -1))
    return np.stack(out)


def phase_cli(torch):
    """The 03c and 03a-predict command lines in-process, as a user runs
    them: cli/hsn VOC2012 (random full-width VGG16 fg + bg at 321^2, 16
    synthetic images in batches of 8), cli/hsn ADP-morph X1.7 with learned
    CRF files, cli/sec_dsrg --task predict from a port checkpoint, then
    cli/extract_eval over what they wrote."""
    import importlib.util
    import os
    import tempfile
    from wsss_tpu_torch.cli import extract_eval as extract_cli
    from wsss_tpu_torch.cli import hsn as hsn_cli
    from wsss_tpu_torch.cli import sec_dsrg as sec_cli
    from wsss_tpu_torch.cli.sec_dsrg import predict_image
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.eval import metrics, reports
    from wsss_tpu_torch.io import checkpoint
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.methods.hsn import HSNSegmenter
    from wsss_tpu_torch.ops.crf import config as crf_config
    from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor
    have = {m: importlib.util.find_spec(m) is not None
            for m in ('PIL', 'matplotlib', 'h5py')}
    print('[cli] optional libraries on this machine: '
          + ', '.join(f'{m} {"yes" if v else "no"}' for m, v in have.items()))
    saveimg = ['--saveimg'] if have['PIL'] else []
    spec = registry.get('VOC2012')
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        ev, out = os.path.join(tmp, 'eval'), os.path.join(tmp, 'out')
        roots = ['--model_root', os.path.join(tmp, 'no_models'),
                 '--eval_root', ev, '--out_root', out] + saveimg

        # --- cli_hsn: VOC2012 VGG16 fg + bg, 16 images, batches of 8 ---
        n_img = 16
        res, _, dt, launches = run_cli(
            torch, hsn_cli.main, ['--dataset', 'VOC2012', '--synthetic_n',
                                  str(n_img), '--batchsize', str(BATCH)]
            + roots)
        check_launches(launches, V2_KERNELS, 'cli_hsn')
        want = 2 * (crf_config.hsn_config('VOC2012', 'VGG16').iterations + 1)
        check(all(launches[k] == want for k in V2_KERNELS),
              f'cli_hsn launches {launches}, expected {want} of each v2 '
              'kernel (2 batches x 11 filters)')
        csv_and_xlsx_agree(os.path.join(ev, 'HSN_VOC2012_VGG16',
                                        'hsn_iou.csv'))
        t0 = time.perf_counter()
        seg = HSNSegmenter(spec, *(_ClassifierHandle.random(
            'VGG16', spec.n_fg_classes, SIZE, seed=s) for s in (0, 1)))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        batches = list(SyntheticWSSS('VOC2012', size=SIZE, n_images=n_img)
                       .batches(BATCH, with_gt=True))
        seg.segment_batch(batches[0].images)                # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = [seg.segment_batch(b.images) for b in batches]
        torch.cuda.synchronize()
        direct_dt = time.perf_counter() - t0
        conf = np.zeros((spec.n_seg_classes,) * 2, np.int64)
        for lab, b in zip(labels, batches):
            conf = metrics.accumulate_confusion(
                conf, lab, torch.as_tensor(b.gt, device=lab.device),
                spec.n_seg_classes)
        miou = metrics.iou_from_confusion(conf)[1]
        print(f'[cli] cli_hsn: {n_img} images through cli.hsn.main in '
              f'{dt:.3f} s = {n_img / dt:.2f} img/s (its handles\' build '
              f'included: {build_s:.3f} s when the phase builds the same '
              f'two); segment_batch on the same host batches '
              f'{n_img / direct_dt:.2f} img/s; launches {launches}')
        print(f'[cli] cli_hsn mIoU {res["miou"]:.6f} against the phase\'s '
              f'own confusion from segment_batch {miou:.6f} (tolerance '
              f'{CLI_MIOU_TOL})')
        check(abs(res['miou'] - miou) <= CLI_MIOU_TOL,
              'cli_hsn mIoU disagrees with segment_batch')
        if have['PIL']:
            names = [n for b in batches for n in b.names]
            got = labels_from_pngs(os.path.join(out, 'HSN_VOC2012_VGG16'),
                                   names, spec.palette_array())
            agree = float((got == torch.cat(labels).cpu().numpy()).mean())
            print(f'[cli] cli_hsn labels read back from its PNGs agree with '
                  f'segment_batch on {agree:.6f} of the pixels (tolerance '
                  f'{CLI_LABEL_FLOOR})')
            check(agree >= CLI_LABEL_FLOOR, 'cli_hsn PNG labels disagree')
        paths['cli_hsn'] = launches

        # --- cli_adp: ADP-morph X1.7, learned CRF files ----------------
        pcc = []
        for htt in ('morph', 'func'):
            path = os.path.join(tmp, f'{htt}_optimal_pcc.npy')
            np.save(path, np.array(
                [crf_config.hsn_config(f'ADP-{htt}').astuple()], np.float64))
            pcc += [f'--{htt}_pcc', path]
        res, _, dt, launches = run_cli(
            torch, hsn_cli.main, ['--dataset', 'ADP-morph', '--model', 'X1.7',
                                  '--synthetic_n', '8'] + roots + pcc)
        check_launches(launches, ('direct_window',), 'cli_adp (the '
                       'direct window)')
        check(sorted(res) == ['miou_func', 'miou_morph']
              and all(np.isfinite(v) for v in res.values()),
              f'cli_adp result {res}')
        for htt in ('morph', 'func'):
            csv_and_xlsx_agree(os.path.join(ev, 'HSN_ADP-morph_X1.7', htt,
                                            'hsn_iou.csv'))
        print(f'[cli] cli_adp: 8 images at 224^2, each split segmented once '
              f'for morph and once for func as the reference does, in '
              f'{dt:.3f} s = {8 / dt:.2f} img/s; {res}; launches {launches}')
        paths['cli_adp'] = launches

        # --- cli_sec: SEC predict from a port checkpoint ---------------
        n_cls, run_id = spec.n_seg_classes, 'SEC_VOC2012_VGG16'
        pred = SECDSRGPredictor.random('SEC', n_cls, seed=0)
        wsss = os.path.join(tmp, 'models_wsss')
        checkpoint.save_checkpoint(os.path.join(wsss, run_id), 1,
                                   {'params': pred.net.state_dict()})
        with MissingWriters('cli'):
            res, text, dt, launches = run_cli(
                torch, sec_cli.main, ['--task', 'predict', '--method', 'SEC',
                                      '--dataset', 'VOC2012', '--synthetic_n',
                                      '4', '--wsss_model_root', wsss] + roots)
        check(f'resumed {run_id} from step 1' in text,
              'cli_sec did not restore the port checkpoint')
        check_launches(launches, V2_KERNELS, 'cli_sec')
        csv_and_xlsx_agree(os.path.join(ev, run_id, 'val_iou.csv'))
        check(os.path.isfile(os.path.join(ev, run_id, 'confusion.png'))
              == have['matplotlib'], 'confusion.png')
        images = list(SyntheticWSSS('VOC2012', size=SIZE, n_images=4)
                      .iter_native(with_gt=True))
        b = images[0]
        predict_image(pred, spec, 'SEC', b.images[0], b.gt.shape[1:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conf = np.zeros((n_cls, n_cls), np.int64)
        for b in images:
            lab = predict_image(pred, spec, 'SEC', b.images[0],
                                b.gt.shape[1:])
            conf = metrics.accumulate_confusion(
                conf, lab, torch.as_tensor(b.gt[0], device=lab.device),
                n_cls)
        torch.cuda.synchronize()
        direct_dt = time.perf_counter() - t0
        miou = metrics.iou_from_confusion(conf)[1]
        print(f'[cli] cli_sec: 4 native-size images through '
              f'cli.sec_dsrg.main in {dt:.3f} s = {4 / dt:.2f} img/s '
              f'(the SECNet build and the checkpoint restore included); '
              f'predict_image on the same images {4 / direct_dt:.2f} img/s; '
              f'mIoU {res["miou"]:.6f} against predict_image\'s {miou:.6f} '
              f'(tolerance {CLI_MIOU_TOL}); launches {launches}')
        check(abs(res['miou'] - miou) <= CLI_MIOU_TOL,
              'cli_sec mIoU disagrees with predict_image')
        paths['cli_sec'] = launches

        # --- extract_eval over the phase's eval root --------------------
        runs = sorted(r['run'] for r in reports.extract_eval(ev))
        want = sorted([os.path.join('HSN_VOC2012_VGG16', 'hsn_iou.csv'),
                       os.path.join('HSN_ADP-morph_X1.7', 'morph',
                                    'hsn_iou.csv'),
                       os.path.join('HSN_ADP-morph_X1.7', 'func',
                                    'hsn_iou.csv'),
                       os.path.join(run_id, 'val_iou.csv')])
        _, text, _, _ = run_cli(torch, extract_cli.main, ['--eval_root', ev])
        check(runs == want and all(text.count(r) == 1 for r in want),
              f'extract_eval listed {runs}, expected {want} once each')
    return paths


# The train phase's card-against-CPU step: VGG16 (BN) at batch 2 and
# TRAIN_CHECK_SIZE^2 (so the CPU's step takes seconds, not a minute), the
# same weights and dropout masks, float32 on both (TF32 off on the card).
# The loss is held to TRAIN_LOSS_RTOL; an updated parameter to
# TRAIN_PARAM_ATOL: cuDNN and the CPU sum in other orders, and BatchNorm
# nets of random weights at batch 2 amplify that in the gradients (the
# CPU tests measure up to 1e-2 of a gradient of ~1.6 between float32 and
# float64 at 32^2), times the step's lr 0.01 and the Nesterov factor 1.9.
TRAIN_CHECK_SIZE = 161
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 5e-4
TRAIN_STEPS = 10


class StepClock:
    """CUDA events at the points of a train step: the forward of `fwd`
    (hooks) and, where given, the end of its `inner` module's forward
    (IRNet's trunk), the CRF layer and the region growing (wrapped where
    the loss modules call them), `net`'s zero_grad (the end of the
    losses, just before the backward) and the optimizer's step (wrapped
    on the instance)."""

    def __init__(self, torch, net, opt, fwd, wrap=(), inner=None):
        self.torch, self.marks = torch, []
        self.hooks = [
            fwd.register_forward_pre_hook(lambda m, a: self.mark('fwd0')),
            fwd.register_forward_hook(lambda m, a, o: self.mark('fwd1'))]
        if inner is not None:
            self.hooks.append(inner.register_forward_hook(
                lambda m, a, o: self.mark('inner1')))
        zero_grad, step = net.zero_grad, opt.step

        def timed_zero_grad(*a, **kw):
            self.mark('loss1')
            return zero_grad(*a, **kw)

        def timed_step():
            self.mark('opt0')
            out = step()
            self.mark('opt1')
            return out
        net.zero_grad, opt.step = timed_zero_grad, timed_step
        self.restore = []
        for mod, name in wrap:
            fn = getattr(mod, name)
            setattr(mod, name, self.timed(name, fn))
            self.restore.append((mod, name, fn))

    def timed(self, name, fn):
        def call(*a, **kw):
            self.mark(name + '0')
            out = fn(*a, **kw)
            self.mark(name + '1')
            return out
        return call

    def mark(self, key):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks.append((key, e))

    def close(self):
        for mod, name, fn in self.restore:
            setattr(mod, name, fn)
        for h in self.hooks:
            h.remove()

    def stages(self):
        """Mean ms per step of each stage over the recorded steps (the
        first step, a warm-up, left out)."""
        self.torch.cuda.synchronize()
        steps, cur = [], {}
        for key, e in self.marks:
            if key == 'fwd0' and cur:
                steps.append(cur)
                cur = {}
            cur[key] = e
        steps.append(cur)
        out = {}
        for s in steps[1:]:
            ms = lambda a, b: s[a].elapsed_time(s[b])
            st = {'forward': ms('fwd0', 'fwd1'),
                  'backward': ms('loss1', 'opt0'),
                  'optimizer': ms('opt0', 'opt1')}
            if 'inner1' in s:
                st['trunk_forward'] = ms('fwd0', 'inner1')
                st['heads_forward'] = ms('inner1', 'fwd1')
            extra = 0.0
            for name in ('crf_layer', 'region_grow'):
                if name + '0' in s:
                    st[name] = ms(name + '0', name + '1')
                    extra += st[name]
            st['losses'] = ms('fwd1', 'loss1') - extra
            for k, v in st.items():
                out[k] = out.get(k, 0.0) + v / (len(steps) - 1)
        return out


def train_loop(torch, step_fn, n_img, steps=TRAIN_STEPS):
    """Losses and img/s of `steps` calls of step_fn(i) (the first a
    warm-up outside the clock), host clock ending in a synchronize; peak
    device memory over the calls."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    parts = [step_fn(0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts += [step_fn(i) for i in range(1, steps)]
    torch.cuda.synchronize()
    ips = n_img * (steps - 1) / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return [{k: float(v) for k, v in p.items()} for p in parts], ips, peak


def stage_line(stages):
    return ', '.join(f'{k} {v:.2f}' for k, v in stages.items())


def seeded_dropout(torch, seed):
    """A stand-in for backbones.dropout whose k-th mask of a run comes
    from a CPU generator seeded seed + k, on any device: the same masks
    for the card's step and the CPU's."""
    calls = []

    def dropout(x, rate, generator):
        g = torch.Generator().manual_seed(seed + len(calls))
        calls.append(x.shape)
        keep = (torch.rand(x.shape, generator=g) < 1.0 - rate).to(x.device)
        return torch.where(keep, x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return dropout, calls


def card_vs_cpu_step(torch, init_state, x, t):
    """(loss on the card, on the CPU, max |param difference|) of one
    ClassifierTrainer step of VGG16 from init_state on batch x, t."""
    from wsss_tpu_torch.models import backbones
    from wsss_tpu_torch.train.classifier import ClassifierTrainer
    out = []
    keep = backbones.dropout
    try:
        for dev in ('cuda', 'cpu'):
            backbones.dropout, calls = seeded_dropout(torch, 1000)
            model = backbones.build_classifier('VGG16', 20)
            model.load_state_dict(init_state)
            tr = ClassifierTrainer(model, lr=0.01, schedule='const',
                                   device=dev)
            m = tr.train_step(x, t, torch.Generator(dev).manual_seed(0))
            check(len(calls) == 2, f'{len(calls)} dropouts on {dev}')
            out.append((float(m['loss']), {k: v.detach().cpu() for k, v in
                                           model.state_dict().items()}))
    finally:
        backbones.dropout = keep
    (l_gpu, p_gpu), (l_cpu, p_cpu) = out
    err = max(float((p_gpu[k].float() - p_cpu[k].float()).abs().max())
              for k in p_gpu)
    return l_gpu, l_cpu, err


def phase_train_steps(torch):
    """train_cls, train_sec, train_dsrg: the trainers at full width on the
    card, TRAIN_STEPS steps each on one synthetic batch."""
    from wsss_tpu_torch.cli.sec_dsrg import _synthetic_cues
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods import dsrg as dsrg_mod
    from wsss_tpu_torch.methods import sec as sec_mod
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.models.backbones import build_classifier
    from wsss_tpu_torch.train.classifier import ClassifierTrainer
    from wsss_tpu_torch.train.sec_dsrg import SECDSRGTrainer
    spec = registry.get('VOC2012')
    b = next(SyntheticWSSS('VOC2012', size=SIZE, n_images=BATCH)
             .batches(BATCH, with_gt=True))
    raw = torch.as_tensor(b.images, device='cuda')
    tags = torch.as_tensor(b.tags, device='cuda')
    paths, ips_of = {}, {}

    # --- train_cls: VGG16 (BN), VOC 20 classes, dropout on, lr 0.01 ---
    model = build_classifier('VGG16', spec.n_fg_classes)
    check(model.dtype == torch.float32, 'train_cls must build in float32')
    trainer = ClassifierTrainer(model, lr=0.01, schedule='const')
    trainer.init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
    x = _normalizer(spec.norm_cues, 'cuda')(raw)
    # the classifier's forward hooks sit on its trunk: the step calls the
    # model's logits method, which no hook sees
    clock = StepClock(torch, model, trainer.tx, model.backbone)
    gen = torch.Generator('cuda')
    K.reset_launch_counts()
    losses, ips, peak = train_loop(torch, lambda i: trainer.train_step(
        x, tags, gen.manual_seed(i)), BATCH)
    paths['train_cls'] = dict(K.LAUNCHES)
    check_launches(paths['train_cls'], (), 'train_cls (no hand kernel)')
    st = clock.stages()
    clock.close()
    ls = [p['loss'] for p in losses]
    print(f'[train] train_cls VGG16 (BN) at {SIZE}^2, batch {BATCH}, '
          f'{TRAIN_STEPS} steps on one batch: {ips:.2f} img/s; ms a step: '
          f'forward + backward {st["forward"] + st["backward"]:.2f} '
          f'({stage_line(st)}); peak memory {peak:.2f} GiB; losses '
          f'{[round(v, 5) for v in ls]}')
    check(all(np.isfinite(ls)) and ls[-1] < ls[0],
          f'train_cls losses {ls}: not finite or not falling')
    ips_of['train_cls'] = ips
    s = TRAIN_CHECK_SIZE
    xs = torch.nn.functional.interpolate(
        raw[:2].permute(0, 3, 1, 2), size=(s, s), mode='bilinear',
        antialias=True).permute(0, 2, 3, 1)
    xs = _normalizer(spec.norm_cues, 'cuda')(xs).cpu()
    l_gpu, l_cpu, err = card_vs_cpu_step(torch, init_state, xs,
                                         tags[:2].cpu())
    print(f'[train] train_cls one step, card against CPU (batch 2 at '
          f'{s}^2, same weights and dropout masks): loss {l_gpu:.6f} vs '
          f'{l_cpu:.6f} (rtol {TRAIN_LOSS_RTOL}), max |dparam| {err:.3e} '
          f'(tolerance {TRAIN_PARAM_ATOL})')
    check(abs(l_gpu - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu),
          'train_cls loss differs between the card and the CPU')
    check(err <= TRAIN_PARAM_ATOL,
          'train_cls updated parameters differ between the card and CPU')
    del trainer, model, clock

    # --- train_sec / train_dsrg: DeepLab at 321^2, 21 classes ----------
    xs = _normalizer(spec.norm_sec, 'cuda')(raw)
    n_seg = spec.n_seg_classes
    grid = (SIZE - 1) // 8 + 1                  # the FCN's seed grid, 41
    cues = [_synthetic_cues(b.gt, n_seg, grid, i)
            for i in range(TRAIN_STEPS)]
    for method in ('SEC', 'DSRG'):
        name = f'train_{method.lower()}'
        tr = SECDSRGTrainer(method, n_seg)
        tr.init(torch.Generator().manual_seed(0))
        wrap = ([(sec_mod, 'crf_layer')] if method == 'SEC' else
                [(dsrg_mod, 'crf_layer'), (dsrg_mod, 'region_grow')])
        clock = StepClock(torch, tr.net, tr.tx, tr.net, wrap)
        dev_cues = [(torch.as_tensor(c, device='cuda'),
                     torch.as_tensor(l, device='cuda')) for c, l in cues]
        K.reset_launch_counts()
        parts, ips, peak = train_loop(torch, lambda i: tr.train_step(
            xs, raw, *dev_cues[i], gen.manual_seed(i)), BATCH)
        paths[name] = dict(K.LAUNCHES)
        st = clock.stages()
        clock.close()
        check_launches(paths[name], (), f'{name} (the seed-grid CRF takes '
                       'the dense structure: no hand kernel)')
        totals = [p['total'] for p in parts]
        check(all(np.isfinite(v) for p in parts for v in p.values()),
              f'{name}: a non-finite loss {parts}')
        grown = (f'; grown_px {[int(p["grown_px"]) for p in parts]}'
                 if method == 'DSRG' else '')
        print(f'[train] {name} {method} DeepLab at {SIZE}^2, batch {BATCH}, '
              f'{TRAIN_STEPS} steps (synthetic cues as the CLI makes them): '
              f'{ips:.2f} img/s; ms a step: FCN forward + backward '
              f'{st["forward"] + st["backward"]:.2f} ({stage_line(st)}); '
              f'peak memory {peak:.2f} GiB; totals '
              f'{[round(v, 5) for v in totals]}{grown}')
        ips_of[name] = ips
        del tr, clock
    return paths, ips_of


def phase_cli_train(torch, ips_of):
    """The training command lines in-process in a temporary directory:
    cli.train_classifier on VOC2012 VGG16 and ADP-morph X1.7 (16 synthetic
    images, batch 8, 1 epoch, calibration, triplet), cli.sec_dsrg --task
    train for SEC and DSRG (1 epoch on 16 images), then --task predict
    --method SEC from the trained checkpoint."""
    import os
    import tempfile
    from wsss_tpu_torch.cli import sec_dsrg as sec_cli
    from wsss_tpu_torch.cli import train_classifier as train_cli
    from wsss_tpu_torch.io import checkpoint
    from wsss_tpu_torch.models.backbones import build_classifier
    paths, n_img = {}, 16
    cwd = os.getcwd()
    try:
        with MissingWriters('cli_train'), \
                tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            roots = ['--model_root', 'models', '--eval_root', 'eval',
                     '--out_root', 'out', '--synthetic_n', str(n_img),
                     '--batchsize', str(BATCH)]
            for ds, tag, n_cls, size in (('VOC2012', 'VGG16', 20, SIZE),
                                         ('ADP-morph', 'X1.7', 51, 224)):
                name = f'cli_train_{tag.lower().replace(".", "")}'
                res, text, dt, launches = run_cli(
                    torch, train_cli.main, ['--dataset', ds, '--model', tag,
                                            '--epochs', '1'] + roots)
                check_launches(launches, (), name)
                sid = f'{ds}_{tag}'
                check(res['sid'] == sid and np.isfinite(res['mean_f1']),
                      f'{name} result {res}')
                check(checkpoint.latest_step(
                    os.path.join('models', sid, 'ckpt')) == 2,
                      f'{name}: no checkpoint at step 2')
                check(os.path.isfile(os.path.join('eval', sid,
                                                  sid + '_metrics.csv')),
                      f'{name}: no _metrics.csv')
                _, _, th = checkpoint.import_triplet(
                    os.path.join('models', sid), sid,
                    build_classifier(tag, n_cls))
                check(th is not None and th.shape == (n_cls,),
                      f'{name}: thresholds {None if th is None else th.shape}')
                wrote = sorted(os.listdir(os.path.join('models', sid)))
                print(f'[cli_train] {name}: {n_img} images at {size}^2 '
                      f'through cli.train_classifier.main (1 epoch, '
                      f'calibration, triplet) in {dt:.3f} s = '
                      f'{n_img / dt:.2f} img/s; {n_cls} thresholds read back '
                      f'through import_triplet; wrote {wrote}; launches '
                      f'{launches}' + (f'; train_cls direct '
                                       f'{ips_of["train_cls"]:.2f} img/s'
                                       if tag == 'VGG16' else ''))
                paths[name] = launches
            wsss = ['--wsss_model_root', 'models_wsss', '--dataset',
                    'VOC2012', '--eval_root', 'eval', '--out_root', 'out',
                    '--batchsize', str(BATCH)]
            for method in ('SEC', 'DSRG'):
                name = f'cli_train_{method.lower()}'
                run_id = f'{method}_VOC2012_VGG16'
                _, text, dt, launches = run_cli(
                    torch, sec_cli.main, wsss + [
                        '--task', 'train', '--method', method, '--epochs',
                        '1', '--synthetic_n', str(n_img)])
                check_launches(launches, (), name)
                check(f'trained {run_id} for 2 steps' in text,
                      f'{name} did not train 2 steps')
                with open(os.path.join('log', run_id, 'train.jsonl')) as f:
                    rows = [json.loads(line) for line in f]
                want = {'step', 'time', 'seed', 'constrain', 'total'} | (
                    {'expand'} if method == 'SEC' else {'grown_px'})
                check(len(rows) == 2 and all(set(r) == want for r in rows),
                      f'{name} log rows {rows}')
                check(checkpoint.latest_step(
                    os.path.join('models_wsss', run_id)) == 2,
                      f'{name}: no checkpoint at step 2')
                print(f'[cli_train] {name}: {n_img} images through '
                      f'cli.sec_dsrg.main --task train (1 epoch, 2 steps) in '
                      f'{dt:.3f} s = {n_img / dt:.2f} img/s against the '
                      f'direct train_step\'s {ips_of["train_" + method.lower()]:.2f}; '
                      f'log keys {sorted(want)}; launches {launches}')
                paths[name] = launches
            _, text, dt, launches = run_cli(
                torch, sec_cli.main, wsss + ['--task', 'predict', '--method',
                                             'SEC', '--synthetic_n', '4'])
            check('resumed SEC_VOC2012_VGG16 from step 2' in text,
                  'the SEC predict run did not restore the trained step 2')
            check_launches(launches, V2_KERNELS, 'cli_predict_trained')
            check(all(launches[k] == 44 for k in V2_KERNELS),
                  f'cli_predict_trained launches {launches}, expected 44 of '
                  'each v2 kernel (4 images x 11 filters)')
            print(f'[cli_train] cli_predict_trained: SEC --task predict from '
                  f'the trained checkpoint, 4 images in {dt:.3f} s = '
                  f'{4 / dt:.2f} img/s; launches {launches}')
            paths['cli_predict_trained'] = launches
            os.chdir(cwd)                 # before the directory goes
    finally:
        os.chdir(cwd)
    return paths


def phase_train(torch):
    paths, ips_of = phase_train_steps(torch)
    paths.update(phase_cli_train(torch, ips_of))
    return paths


# --- 03b: IRNet's inference stages ------------------------------------------
# The irn phase's inputs: 4 VOC-sized images; one ADP image at its native
# size (the walk's n = (1088/4)^2 = 73 984: a 21.9 GB transition matrix,
# two of them at the walk's peak); one small image through the whole
# chain on the card and on the CPU; 4 synthetic images through the CLI.
IRN_VOC_N, IRN_VOC_HW = 4, (375, 500)
IRN_ADP_SIZE = 1088
IRN_SMALL = 161
IRN_CLI_N = 16             # two full batches of 8: train_irn takes 2 steps
IRN_CAM_TOL = 1e-4          # card against CPU, cam and high_res maps
IRN_IR_FLOOR = 0.99         # ir-labels: the card's scatter grid against
#                             the CPU's route (PERF.md §6: 0.9954 apart)
IRN_SEM_FLOOR = 0.999       # sem-seg labels: float32 walk, then argmax


def timed(torch, fn):
    """(fn(), host seconds), the clock ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class WalkClock:
    """Stands in for methods.irnet.propagate_to_edge while installed:
    each walk's host seconds (synchronized around it), its n and
    exp_times."""

    def __init__(self, torch, irnet):
        self.torch, self.irnet = torch, irnet
        self.fn = irnet.propagate_to_edge
        self.walks = []

    def __enter__(self):
        self.irnet.propagate_to_edge = self
        return self

    def __exit__(self, *exc):
        self.irnet.propagate_to_edge = self.fn

    def __call__(self, cam, edge, **kw):
        out, dt = timed(self.torch, lambda: self.fn(cam, edge, **kw))
        self.walks.append((dt, cam.shape[1] * cam.shape[2], kw['exp_times']))
        return out

    def report(self, label, smi):
        """Print and return (seconds, TFLOP/s, share of the f32 bound) of
        the walks: 2 n^3 flops a squaring at F32_FLOPS."""
        secs = sum(w[0] for w in self.walks)
        flops = sum(2.0 * n ** 3 * e for _, n, e in self.walks)
        bound_s = flops / F32_FLOPS
        ns = sorted({n for _, n, _ in self.walks})
        print(f'[{label}] walk: {len(self.walks)} walks, n {ns}, exp_times '
              f'{sorted({e for _, _, e in self.walks})}: '
              f'{1e3 * secs / len(self.walks):.1f} ms a walk, '
              f'{flops / secs / 1e12:.2f} TFLOP/s ({flops:.4g} flops), '
              f'bound {1e3 * bound_s / len(self.walks):.1f} ms a walk at '
              f'{F32_FLOPS / 1e12:.0f} TFLOP/s f32 = {bound_s / secs:.3f} of '
              f'it ({smi})')
        return secs, flops / secs / 1e12, bound_s / secs


def irn_k11_launches(cfg, calls):
    """flat_color_blur launches that crf_label_refine makes over calls
    [(hw, n_labels)]: one a filter (the iterations and the C 1
    normalizer) where the structure is the scatter grid, else none."""
    from wsss_tpu_torch.ops.crf import meanfield as mf
    return sum(cfg.iterations + 1 for hw, c in calls
               if mf.bilateral_structure(hw, cfg.bi_sxy, cfg.bi_srgb)
               == 'grid' and not mf._mxu_ok(hw, c, cfg))


def ir_label_calls(dataset, dicts, hws):
    """(hw, n_labels) of each crf_label_refine call cam_to_ir_label
    makes: two an image on VOC, one on ADP (none for empty keys)."""
    per = 2 if dataset == 'VOC2012' else 1
    return [(hw, len(d['keys']) + 1) for d, hw in zip(dicts, hws)
            if len(d['keys'])] * per


def irn_images(torch, seed, n, hw, n_fg, n_tags=2):
    """Seeded uint8 host images [n,H,W,3] of flat-coloured blocks with
    noise (structured_case) and tags [n, n_fg] with n_tags classes set."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    imgs, _ = structured_case(torch, gen, n, hw, 8)
    rng = np.random.default_rng(seed)
    tags = np.zeros((n, n_fg), np.float32)
    for t in tags:
        t[rng.choice(n_fg, n_tags, replace=False)] = 1
    return imgs.round().to(torch.uint8).cpu().numpy(), tags


def irn_net(torch, backbone, clf, seed):
    """An IRNet on the card: heads from `seed`, trunk transplanted from
    the classifier `clf`."""
    from wsss_tpu_torch.models.backbones import init_random
    from wsss_tpu_torch.models.irn import IRNet
    from wsss_tpu_torch.models.transplant import transplant_classifier_trunk
    net = init_random(IRNet(backbone), torch.Generator().manual_seed(seed))
    transplant_classifier_trunk(clf, net, backbone)
    return net.to('cuda').eval()


def irn_edges(torch, net, spec, imgs, crop, device='cuda'):
    """edge_displacement_inference on the top-left `crop` of each image,
    disp_mean 0 (the CLI's make_sem_seg input)."""
    from wsss_tpu_torch.data import augment
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.models.irn import edge_displacement_inference
    norm = _normalizer(spec.norm_irn, device)
    out = []
    for img in imgs:
        x = torch.as_tensor(augment.top_left_crop(img, crop, 0)[None]).to(
            device, torch.float32)
        out.append(edge_displacement_inference(net, norm(x), [0.0, 0.0])[0])
    return out


def check_sem(sem, keys_pad, hw, label):
    check(sem.shape == tuple(hw) and sem.dtype == np.uint8,
          f'{label}: sem-seg labels {sem.shape} {sem.dtype}')
    check(set(np.unique(sem).tolist()) <= set(np.asarray(keys_pad).tolist()),
          f'{label}: sem-seg labels outside the keys')


def phase_irn_voc(torch, smi):
    """VOC2012 VGG16 through the five stages on 4 images of 375x500."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.ops.crf import config as crf_config
    spec = registry.get('VOC2012')
    conf_fg, exp_times = crf_config.IRN_TUNED[('VOC2012', 'VGG16')]
    cfg = crf_config.IRN_LABEL
    handle = _ClassifierHandle.random('VGG16', spec.n_fg_classes, SIZE,
                                      seed=0)
    ci = irnet.CAMInference(handle, spec, 'VGG16')
    check(ci.scales == (1.0, 0.5, 1.5, 2.0), f'scales {ci.scales}')
    net = irn_net(torch, 'vgg16', handle.model, seed=1)
    crop = SIZE // 16 * 16
    imgs, tags = irn_images(torch, 11, IRN_VOC_N, IRN_VOC_HW,
                            spec.n_fg_classes)
    hws = [IRN_VOC_HW] * IRN_VOC_N

    def chain(sl):
        dicts = ci.make_cam_batch(imgs[sl], tags[sl])
        ir = [irnet.cam_to_ir_label(i, d, 'VOC2012', conf_fg)
              for i, d in zip(imgs[sl], dicts)]
        edges = irn_edges(torch, net, spec, imgs[sl], crop)
        return [irnet.make_sem_seg(e, d, 'VOC2012', IRN_VOC_HW,
                                   exp_times=exp_times)
                for e, d in zip(edges, dicts)]
    timed(torch, lambda: chain(slice(0, 1)))                  # warm-up
    stage, peak = {}, {}

    def stage_run(name, fn):
        torch.cuda.reset_peak_memory_stats()
        out, stage[name] = timed(torch, fn)
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out
    K.reset_launch_counts()
    dicts = stage_run('make_cam', lambda: ci.make_cam_batch(imgs, tags))
    after_cam = dict(K.LAUNCHES)
    preds = stage_run('eval_cam', lambda: [
        irnet.eval_cam_pred(d, 'VOC2012', 0.15) for d in dicts])
    ir = stage_run('cam_to_ir_label', lambda: [
        irnet.cam_to_ir_label(i, d, 'VOC2012', conf_fg)
        for i, d in zip(imgs, dicts)])
    after_ir = dict(K.LAUNCHES)
    edges = stage_run('edge', lambda: irn_edges(torch, net, spec, imgs,
                                                crop))
    with WalkClock(torch, irnet) as clock:
        sem = stage_run('make_sem_seg', lambda: [
            irnet.make_sem_seg(e, d, 'VOC2012', IRN_VOC_HW,
                               exp_times=exp_times)
            for e, d in zip(edges, dicts)])
    launches = dict(K.LAUNCHES)
    check_launches(launches, SCATTER, 'irn_voc')
    check(not any(after_cam.values()), f'make_cam launched {after_cam}')
    want = irn_k11_launches(cfg, ir_label_calls('VOC2012', dicts, hws))
    check(after_ir['flat_color_blur'] == launches['flat_color_blur'] == want,
          f'irn_voc flat_color_blur launches {launches["flat_color_blur"]}'
          f' (after cam_to_ir_label {after_ir["flat_color_blur"]}), the '
          f'structures predict {want}')
    n = IRN_VOC_N
    for name, dt in stage.items():
        print(f'[irn_voc] {name}: {n} images of {IRN_VOC_HW} in {dt:.3f} s = '
              f'{n / dt:.2f} img/s, peak memory {peak[name]:.2f} GiB ({smi})')
    walk_s, tflops, share = clock.report('irn_voc', smi)
    print(f'[irn_voc] the walk is {walk_s / stage["make_sem_seg"]:.3f} of '
          f'make_sem_seg ({1e3 * walk_s / n:.1f} of '
          f'{1e3 * stage["make_sem_seg"] / n:.1f} ms an image; exp_times '
          f'{exp_times}); cam_to_ir_label '
          f'{1e3 * stage["cam_to_ir_label"] / n:.1f} ms an image with '
          f'{want // n} flat_color_blur launches an image ({smi})')
    for d, p, lab, s, t in zip(dicts, preds, ir, sem, tags):
        keys = np.where(t > 0.5)[0]
        check(np.array_equal(d['keys'], keys), f'keys {d["keys"]} {keys}')
        sh = irnet.get_strided_size(IRN_VOC_HW, 4)
        check(d['cam'].shape == (len(keys),) + sh
              and d['high_res'].shape == (len(keys),) + IRN_VOC_HW
              and np.isfinite(d['high_res']).all()
              and 0 <= float(d['high_res'].min())
              and float(d['high_res'].max()) <= 1,
              f'cam dict {d["cam"].shape} {d["high_res"].shape}')
        keys_pad = np.concatenate([[0], keys + 1])
        check(p.shape == IRN_VOC_HW and set(np.unique(p)) <= set(keys_pad),
              'eval_cam_pred labels')
        check(set(np.unique(lab).tolist()) <= set(keys_pad.tolist()) | {255},
              'ir-labels outside the keys')
        check_sem(s, keys_pad, IRN_VOC_HW, 'irn_voc')
    with K.plain_versions():
        plain = [irnet.cam_to_ir_label(i, d, 'VOC2012', conf_fg)
                 for i, d in zip(imgs, dicts)]
    agree = float(np.mean([(a == b).mean() for a, b in zip(ir, plain)]))
    print(f'[irn_voc] ir-labels, kernels vs plain versions: {agree:.6f}; '
          f'ignored {np.mean([(x == 255).mean() for x in ir]):.4f}, '
          f'background {np.mean([(x == 0).mean() for x in ir]):.4f} of the '
          f'pixels')
    check(agree >= 0.999, f'irn_voc ir-labels agree {agree} < 0.999')
    # K11 at this path's own shape: the first image's grid at C = 1 +
    # |keys| (counted apart from the path's launches, read above)
    from wsss_tpu_torch.ops.crf.meanfield import BilateralGrid
    c = len(dicts[0]['keys']) + 1
    bg = BilateralGrid(torch.as_tensor(imgs[:1]).to('cuda', torch.float32),
                       cfg.bi_sxy, cfg.bi_srgb)
    gen = torch.Generator(device='cuda').manual_seed(14)
    x = torch.rand((1,) + IRN_VOC_HW + (c,), generator=gen, device='cuda')
    k11 = hold_flat_blur(torch, bg, x, f'irn_voc grid {bg.gshape} C={c}',
                         'split', timed=True)
    ips = {k: n / v for k, v in stage.items()}
    cases = {name: {f'irn_voc_c{c}': r} for name, r in k11.items()}
    return {'irn_voc': launches}, handle, net, ips, cases


def phase_irn_adp(torch, smi):
    """One ADP-morph image at its native 1088^2 with X1.7: make_cam,
    cam_to_ir_label (which raises there, as the reference's does),
    make_sem_seg with an M7 IRNet: the walk at n = 73 984 must fit the
    card."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.ops.crf import config as crf_config
    from wsss_tpu_torch.ops.crf import meanfield as mf
    spec = registry.get('ADP-morph')
    conf_fg, exp_times = crf_config.IRN_TUNED[('ADP-morph', 'X1.7')]
    cfg = crf_config.IRN_LABEL
    hw = (IRN_ADP_SIZE, IRN_ADP_SIZE)
    handle = _ClassifierHandle.random('X1.7', 51, spec.clf_size_m7, seed=2)
    ci = irnet.CAMInference(handle, spec, 'X1.7', adp_htt='morph')
    net = irn_net(torch, 'm7', handle.model, seed=3)
    imgs, tags = irn_images(torch, 12, 1, hw, spec.n_fg_classes, n_tags=3)
    torch.cuda.empty_cache()
    stage, peak = {}, {}

    def stage_run(name, fn):
        torch.cuda.reset_peak_memory_stats()
        out, stage[name] = timed(torch, fn)
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out
    K.reset_launch_counts()
    d = stage_run('make_cam', lambda: ci.make_cam(imgs[0], tags[0]))
    structure = mf.bilateral_structure(hw, cfg.bi_sxy, cfg.bi_srgb)
    c = len(d['keys']) + 1
    grid_cells = int(np.prod(mf._grid_shape(hw, cfg.bi_sxy, cfg.bi_srgb)))
    # At 1088^2 IRN_LABEL has no structure, in the reference as here:
    # the scatter grid would pass meanfield's 80 M-cell limit and the
    # window has 70 686 offsets (> 40 000), so make_bilateral raises
    try:
        irnet.cam_to_ir_label(imgs[0], d, 'ADP-morph', conf_fg)
        check(False, 'cam_to_ir_label ran at ADP\'s native size, where '
              'the reference raises')
    except ValueError as e:
        check('intractable' in str(e), f'cam_to_ir_label raised {e}')
        print(f'[irn_adp] cam_to_ir_label at {hw} raises, as the '
              f'reference does: {e}')
    (edge,) = stage_run('edge', lambda: irn_edges(
        torch, net, spec, imgs, spec.clf_size_m7 // 16 * 16))
    torch.cuda.empty_cache()
    with WalkClock(torch, irnet) as clock:
        sem = stage_run('make_sem_seg', lambda: irnet.make_sem_seg(
            edge, d, 'ADP-morph', hw, exp_times=exp_times))
    launches = dict(K.LAUNCHES)
    want = irn_k11_launches(cfg, [(hw, c)])
    check_launches(launches, SCATTER if want else (), 'irn_adp')
    check(launches['flat_color_blur'] == want,
          f'irn_adp flat_color_blur launches {launches["flat_color_blur"]},'
          f' the structure ({structure}) predicts {want}')
    for name, dt in stage.items():
        print(f'[irn_adp] {name}: 1 image of {hw} in {dt:.3f} s, peak '
              f'memory {peak[name]:.2f} GiB ({smi})')
    n = clock.walks[0][1]
    check(n == (IRN_ADP_SIZE // 4) ** 2, f'walk n {n}')
    clock.report('irn_adp', smi)
    print(f'[irn_adp] the walk holds two [n, n] float32 matrices: '
          f'{2 * n * n * 4 / 1e9:.2f} GB; make_sem_seg peaked at '
          f'{peak["make_sem_seg"]:.2f} GiB of the card\'s '
          f'{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}'
          f' GiB ({smi})')
    print(f'[irn_adp] the {structure} structure at {hw}: the scatter '
          f'grid would hold {grid_cells} cells x C {c} = '
          f'{grid_cells * c * 4 / 1e9:.2f} GB (meanfield routes to it up to '
          f'80 M cells); flat_color_blur launches {want}')
    keys = d['keys']
    check(keys[0] == 0 and len(keys) == 4, f'ADP keys {keys}')
    check(d['high_res'].shape == (len(keys),) + hw
          and np.isfinite(d['high_res']).all(), 'ADP cam dict')
    check_sem(sem, keys, hw, 'irn_adp')
    print(f'[irn_adp] sem-seg labels {np.unique(sem).tolist()}')
    return {'irn_adp': launches}


def phase_irn_card_vs_cpu(torch, smi, handle, net):
    """One small image through the whole chain on the card and on the
    CPU, the same weights."""
    import copy
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.ops.crf import config as crf_config
    from wsss_tpu_torch.ops.crf import meanfield as mf
    spec = registry.get('VOC2012')
    conf_fg, exp_times = crf_config.IRN_TUNED[('VOC2012', 'VGG16')]
    hw = (IRN_SMALL, IRN_SMALL)
    imgs, tags = irn_images(torch, 13, 1, hw, spec.n_fg_classes)
    img, tag = imgs[0], tags[0]
    crop = SIZE // 16 * 16

    def chain(h, n, device):
        ci = irnet.CAMInference(h, spec, 'VGG16', device=device)
        d = ci.make_cam(img, tag)
        ir = irnet.cam_to_ir_label(img, d, 'VOC2012', conf_fg, device=device)
        (edge,) = irn_edges(torch, n, spec, imgs, crop, device=device)
        sem = irnet.make_sem_seg(edge, d, 'VOC2012', hw, exp_times=exp_times,
                                 device=device)
        return d, ir, sem
    K.reset_launch_counts()
    (d_c, ir_c, sem_c), dt_c = timed(torch, lambda: chain(handle, net,
                                                          'cuda'))
    launches = dict(K.LAUNCHES)
    h_cpu = _ClassifierHandle(copy.deepcopy(handle.model).cpu(),
                              handle.thresholds.cpu().numpy(), SIZE,
                              device='cpu')
    # the CPU side is the port's own plain path: the scatter grid, not the
    # host's permutohedral library (which irn_label may have built)
    native_was = mf._NATIVE_DISABLED
    mf._NATIVE_DISABLED = True
    try:
        t0 = time.perf_counter()
        d_h, ir_h, sem_h = chain(h_cpu, copy.deepcopy(net).cpu(), 'cpu')
        dt_h = time.perf_counter() - t0
    finally:
        mf._NATIVE_DISABLED = native_was
    if mf._fine_color_native_ok(hw, crf_config.IRN_LABEL):
        nat = irnet.cam_to_ir_label(img, d_h, 'VOC2012', conf_fg,
                                    device='cpu')
        print(f'[irn_card_vs_cpu] for the record, the CPU with the host\'s '
              f'permutohedral library (the native route): ir-labels agree '
              f'{float((nat == ir_c).mean()):.6f} with the card\'s')
    want = irn_k11_launches(crf_config.IRN_LABEL,
                            ir_label_calls('VOC2012', [d_c], [hw]))
    check_launches(launches, SCATTER, 'irn_card_vs_cpu')
    check(launches['flat_color_blur'] == want,
          f'irn_card_vs_cpu launches {launches}, expected {want}')
    check(np.array_equal(d_c['keys'], d_h['keys']),
          f'keys {d_c["keys"]} vs {d_h["keys"]}')
    errs = {k: float(np.abs(d_c[k] - d_h[k]).max())
            for k in ('cam', 'high_res')}
    ir_agree = float((ir_c == ir_h).mean())
    sem_agree = float((sem_c == sem_h).mean())
    print(f'[irn_card_vs_cpu] one {hw} image through the chain: card '
          f'{dt_c:.3f} s, CPU {dt_h:.3f} s; cam max |diff| {errs["cam"]:.3e},'
          f' high_res {errs["high_res"]:.3e} (tolerance {IRN_CAM_TOL}); '
          f'ir-labels agree {ir_agree:.6f} (floor {IRN_IR_FLOOR}), sem-seg '
          f'{sem_agree:.6f} (floor {IRN_SEM_FLOOR}); labels '
          f'{np.unique(sem_c).tolist()} ({smi})')
    check(max(errs.values()) <= IRN_CAM_TOL, f'cams differ {errs}')
    check(ir_agree >= IRN_IR_FLOOR, f'ir-labels agree {ir_agree}')
    check(sem_agree >= IRN_SEM_FLOOR, f'sem-seg labels agree {sem_agree}')
    return {'irn_card_vs_cpu': launches}


def irn_cli_k11(torch, run, n):
    """flat_color_blur launches the structures predict for cli.irn's
    cam_to_ir_label over the cam dicts under `run`."""
    import os
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.io import artifacts
    from wsss_tpu_torch.ops.crf import config as crf_config
    hws, dicts = [], []
    for b in SyntheticWSSS('VOC2012', size=SIZE, n_images=n).iter_native():
        hws.append(b.images.shape[1:3])
        dicts.append(artifacts.read_cam_npy(os.path.join(
            run, 'cam', b.names[0] + '.npy')))
    return irn_k11_launches(crf_config.IRN_LABEL, ir_label_calls(
        'VOC2012', dicts, hws))


def phase_cli_irn(torch, smi, ips):
    """cli.irn.main over its six passes one at a time on SyntheticWSSS
    VOC2012 in a temporary directory (make_sem_seg restores the
    checkpoint train_irn wrote), then --passes all once, whole."""
    import os
    import tempfile
    from PIL import Image
    from wsss_tpu_torch.cli import irn as irn_cli
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.eval import metrics
    from wsss_tpu_torch.io import checkpoint
    spec = registry.get('VOC2012')
    n = IRN_CLI_N
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, 'work')
        run = os.path.join(work, 'IRN_VOC2012_VGG16')
        base = ['--dataset', 'VOC2012', '--model', 'VGG16', '--img_size',
                str(SIZE), '--synthetic_n', str(n), '--batchsize',
                str(BATCH), '--model_root', os.path.join(tmp, 'no_models')]
        argv = base + ['--work_root', work]
        for ps in irn_cli.PASSES:
            res, text, dt, launches = run_cli(
                torch, irn_cli.main, argv + ['--passes', ps])
            if ps == 'cam_to_ir_label':
                want = irn_cli_k11(torch, run, n)
                check_launches(launches, SCATTER, 'cli_irn cam_to_ir_label')
                check(launches['flat_color_blur'] == want,
                      f'cli_irn cam_to_ir_label launches {launches}, the '
                      f'structures predict {want}')
            else:
                check_launches(launches, (), f'cli_irn {ps}')
            if ps == 'train_irn':
                check('[train_irn] trained; disp_mean=' in text
                      and checkpoint.latest_step(
                          os.path.join(run, 'irn_ckpt')) == 0,
                      'cli_irn train_irn wrote no checkpoint at step 0')
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            direct = {'make_cam': 'make_cam', 'cam_to_ir_label':
                      'cam_to_ir_label', 'make_sem_seg': 'make_sem_seg',
                      'eval_cam': 'eval_cam',
                      'train_irn': 'irn_train_voc'}.get(ps)
            beside = (f'; direct call in irn_voc / irn_train_voc '
                      f'{ips[direct]:.2f} img/s' if direct else '')
            if ps == 'make_sem_seg':
                beside += f' (with the edge inference {ips["edge"]:.2f})'
            print(f'[cli_irn] {ps}: {n} images through cli.irn.main in '
                  f'{dt:.3f} s = {n / dt:.2f} img/s{beside}; launches '
                  f'{ {k: v for k, v in launches.items() if v} } ({smi})')
            if ps == 'eval_sem_seg':
                miou = res['miou']
        conf = np.zeros((spec.n_seg_classes,) * 2, np.int64)
        for b in SyntheticWSSS('VOC2012', size=SIZE,
                               n_images=n).iter_native(with_gt=True):
            pred = np.asarray(Image.open(os.path.join(
                run, 'sem_seg', b.names[0] + '.png'))).astype(np.int32)
            check(pred.shape == b.gt.shape[1:], 'sem-seg PNG shape')
            pred[pred == 255] = 0
            conf = metrics.accumulate_confusion(
                conf, torch.as_tensor(pred), torch.as_tensor(b.gt[0]),
                spec.n_seg_classes)
        own = metrics.iou_from_confusion(conf)[1]
        print(f'[cli_irn] eval_sem_seg mIoU {miou:.6f}, the phase\'s own '
              f'confusion of the written PNGs {own:.6f}')
        check(abs(miou - own) <= 1e-12, 'eval_sem_seg mIoU differs')
        work_all = os.path.join(tmp, 'work_all')
        res, text, dt, launches = run_cli(
            torch, irn_cli.main, base + ['--work_root', work_all])
        want = irn_cli_k11(torch, os.path.join(work_all,
                                               'IRN_VOC2012_VGG16'), n)
        check_launches(launches, SCATTER, 'cli_irn_all')
        check(launches['flat_color_blur'] == want,
              f'cli_irn --passes all launches {launches}, the structures '
              f'of its cam_to_ir_label predict {want}')
        check(sorted(res) == ['cam_miou', 'miou']
              and all(0.0 <= v <= 1.0 for v in res.values()),
              f'cli_irn --passes all result {res}')
        print(f'[cli_irn] --passes all (the default), whole: {n} images in '
              f'{dt:.3f} s, mIoU {res["miou"]:.6f}, cam mIoU '
              f'{res["cam_miou"]:.6f}; launches '
              f'{ {k: v for k, v in launches.items() if v} } ({smi})')
    return {'cli_irn': total, 'cli_irn_all': launches}


# --- 03b: IRNet training ----------------------------------------------------
# IRNTrainer at full width: batch 8 at the VOC VGG16 crop (320: the /4
# grid 80, radius 10 -> P = 152 paths, M = 71 x 62 = 4402 pairs) and at
# the ADP X1.7 crop (224, m7: grid 56, M = 47 x 38 = 1786); one step of
# each backbone at batch 2, crop 64, on the card against the CPU.
IRN_TRAIN_BATCH = 8
IRN_TRAIN_CHECK = 64
IRN_DISP_MEAN_TOL = 1e-5


def irn_train_batch(seed, n, crop, n_seg, pidx):
    """(n seeded uint8 images [n,crop,crop,3], the three affinity-label
    arrays [n,P,M] float32, the host seconds the labels took).  Each
    image is flat-coloured 40-px blocks of background and two classes (a
    colour a class) plus noise; its ir-label map follows the blocks with
    255 on a 4-px border around each, reduced by the CLI's /4 rescale and
    turned into labels by affinity_labels, on the host.  numpy only: the
    same batch on any machine."""
    from wsss_tpu_torch.data import augment
    from wsss_tpu_torch.methods import irnet
    rng = np.random.default_rng(seed)
    palette = rng.uniform(0, 255, (n_seg, 3))
    nb = -(-crop // 40)
    at = np.arange(crop) % 40
    border = (at < 2) | (at >= 38)
    imgs, labs = [], []
    for _ in range(n):
        classes = [0] + list(rng.choice(np.arange(1, n_seg), 2,
                                        replace=False))
        lab = np.repeat(np.repeat(rng.choice(classes, (nb, nb)), 40, 0),
                        40, 1)[:crop, :crop].astype(np.int64)
        img = palette[lab] + rng.normal(0, 10, (crop, crop, 3))
        imgs.append(np.clip(img, 0, 255).round().astype(np.uint8))
        lab[border[:, None] | border[None, :]] = 255
        labs.append(lab)
    g = crop // 4
    t0 = time.perf_counter()
    packs = [irnet.affinity_labels(augment.pil_rescale(lab, 0.25, 0)[:g, :g],
                                   pidx, n_seg) for lab in labs]
    host_s = time.perf_counter() - t0
    return np.stack(imgs), [np.stack(z) for z in zip(*packs)], host_s


def irn_train_path(torch, smi, name, backbone, spec, clf, crop):
    """TRAIN_STEPS IRNTrainer steps at batch 8 on one synthetic batch
    (max_step TRAIN_STEPS), the trunk transplanted from `clf`, the heads
    from seed 1: img/s, stage ms
    by CUDA events, host time, peak memory; the trunk bit-equal after,
    every loss finite, the total falling.  Returns (launches, img/s)."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.models.transplant import transplant_classifier_trunk
    n_seg = spec.n_seg_classes
    # the poly schedule over the run's own length, as cli.irn sets
    # max_step (at the default 1000 the step stays ~0.1, x10 on fc_dp*,
    # and the loss on one batch oscillates)
    tr = irnet.IRNTrainer(backbone, crop_size=crop,
                          max_step=TRAIN_STEPS)
    tr.init(torch.Generator().manual_seed(1))
    transplant_classifier_trunk(clf, tr.net, backbone)
    trunk0 = {k: v.clone() for k, v in tr.net.trunk.state_dict().items()}
    b = IRN_TRAIN_BATCH
    imgs, labels, host_s = irn_train_batch(21, b, crop, n_seg,
                                           tr.path_index)
    p, m = labels[0].shape[1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = torch.from_numpy(imgs).to('cuda')
    dev_labels = [torch.from_numpy(a).to('cuda') for a in labels]
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    xn = _normalizer(spec.norm_irn, 'cuda')(x.to(torch.float32))
    clock = StepClock(torch, tr.net, tr.tx, tr.net, inner=tr.net.trunk)
    K.reset_launch_counts()
    parts, ips, peak = train_loop(
        torch, lambda i: tr.train_step(xn, *dev_labels), b)
    launches = dict(K.LAUNCHES)
    st = clock.stages()
    clock.close()
    check_launches(launches, (), f'{name} (no hand kernel)')
    totals = [q['total'] for q in parts]
    mb = b * p * m * 4 / 1e6
    print(f'[irn_train] {name}: IRNet {backbone} at crop {crop}, batch {b}, '
          f'radius {tr.path_index.radius} (P {p}, M {m}: each label tensor '
          f'[{b},{p},{m}] f32 {mb:.1f} MB, the pair displacement '
          f'[{b},2,{p},{m}] {2 * mb:.1f} MB), {TRAIN_STEPS} steps on one '
          f'batch: {ips:.2f} img/s; ms a step: trunk forward '
          f'{st["trunk_forward"]:.2f}, heads forward '
          f'{st["heads_forward"]:.2f}, to_affinity_sliced + losses '
          f'{st["losses"]:.2f}, backward {st["backward"]:.2f}, optimizer '
          f'{st["optimizer"]:.2f}; on the host apart from the step: '
          f'affinity_labels for {b} images {1e3 * host_s:.1f} ms, '
          f'host-to-card copy {1e3 * copy_s:.1f} ms (a step '
          f'{1e3 * b / ips:.1f} ms); peak memory {peak:.2f} GiB; totals '
          f'{[round(v, 5) for v in totals]} ({smi})')
    check(all(np.isfinite(v) for q in parts for v in q.values()),
          f'{name}: a non-finite loss {parts}')
    check(totals[-1] < totals[0], f'{name}: the loss did not fall {totals}')
    check(all(torch.equal(v, trunk0[k])
              for k, v in tr.net.trunk.state_dict().items()),
          f'{name}: the trunk moved')
    return launches, ips


def phase_irn_train_card_vs_cpu(torch, smi):
    """The displacement-mean calibration, then one IRNTrainer step, of
    vgg16 and of m7 at batch 2, crop 64, on the card and on the CPU from
    the same weights and batch."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.models.backbones import init_random
    spec = registry.get('VOC2012')
    crop, n_seg = IRN_TRAIN_CHECK, spec.n_seg_classes
    K.reset_launch_counts()
    for backbone in ('vgg16', 'm7'):
        trs = {dev: irnet.IRNTrainer(backbone, crop_size=crop,
                                     device=dev) for dev in ('cuda', 'cpu')}
        ref = trs['cpu']
        ref.init(torch.Generator().manual_seed(4))
        init_random(ref.net.trunk, torch.Generator().manual_seed(5))
        trs['cuda'].net.load_state_dict(ref.net.state_dict())
        imgs, labels, _ = irn_train_batch(22, 2, crop, n_seg,
                                          ref.path_index)
        out = {}
        for dev, tr in trs.items():
            xn = _normalizer(spec.norm_irn, dev)(
                torch.from_numpy(imgs).to(dev, torch.float32))
            disp_mean = tr.calibrate_disp_mean([xn])
            total = float(tr.train_step(xn, *labels)['total'])
            out[dev] = (total, {k: v.detach().cpu()
                                for k, v in tr.net.state_dict().items()},
                        disp_mean)
        (l_gpu, p_gpu, d_gpu), (l_cpu, p_cpu, d_cpu) = out['cuda'], \
            out['cpu']
        err = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_gpu)
        derr = float(np.abs(d_gpu - d_cpu).max())
        print(f'[irn_train] card_vs_cpu {backbone}, one step at batch 2, '
              f'crop {crop}: loss {l_gpu:.6f} vs {l_cpu:.6f} (rtol '
              f'{TRAIN_LOSS_RTOL}), max |dparam| {err:.3e} (tolerance '
              f'{TRAIN_PARAM_ATOL}); disp_mean {d_gpu} vs {d_cpu}, max '
              f'|diff| {derr:.3e} (tolerance {IRN_DISP_MEAN_TOL}) ({smi})')
        check(abs(l_gpu - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu),
              f'irn_train {backbone} loss differs between card and CPU')
        check(err <= TRAIN_PARAM_ATOL,
              f'irn_train {backbone} parameters differ between card and CPU')
        check(derr <= IRN_DISP_MEAN_TOL,
              f'irn_train {backbone} disp_mean differs between card and CPU')
    launches = dict(K.LAUNCHES)
    check_launches(launches, (), 'irn_train_card_vs_cpu')
    return {'irn_train_card_vs_cpu': launches}


def phase_irn_train(torch, smi, handle):
    """irn_train_voc (vgg16 on the irn_voc classifier, crop 320),
    irn_train_adp (m7 on an ADP-morph X1.7 classifier of seed 2, crop
    224: the edge logits' antialiased resize and its backward), then the
    card against the CPU.  Returns ({path: launches}, {path: img/s})."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    paths, ips = {}, {}
    voc = registry.get('VOC2012')
    paths['irn_train_voc'], ips['irn_train_voc'] = irn_train_path(
        torch, smi, 'irn_train_voc', 'vgg16', voc, handle.model,
        SIZE // 16 * 16)
    adp = registry.get('ADP-morph')
    x17 = _ClassifierHandle.random('X1.7', 51, adp.clf_size_m7, seed=2)
    paths['irn_train_adp'], ips['irn_train_adp'] = irn_train_path(
        torch, smi, 'irn_train_adp', 'm7', adp, x17.model,
        adp.clf_size_m7 // 16 * 16)
    del x17
    torch.cuda.empty_cache()
    paths.update(phase_irn_train_card_vs_cpu(torch, smi))
    return paths, ips


# --- the whole chain --------------------------------------------------------
PARITY_N = 16


def phase_parity(torch, smi):
    """cli.parity.main in its synthetic smoke mode on the card in a
    temporary working directory: VOC2012, VGG16 at 321^2, 01 -> 02 ->
    03a -> 03b -> 03c; a report row for each method with its mIoU in [0,
    1]; the v2 kernels (HSN, SEC/DSRG prediction) and K11 (03b's
    cam_to_ir_label) launched."""
    import os
    import tempfile
    from wsss_tpu_torch.cli import parity
    from wsss_tpu_torch.eval import baseline
    cwd = os.getcwd()
    try:
        with MissingWriters('parity'), \
                tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            rows, text, dt, launches = run_cli(torch, parity.main, [
                '--datasets', 'VOC2012', '--models', 'vgg16',
                '--synthetic_n', str(PARITY_N), '--clf_epochs', '1'])
            os.chdir(cwd)                 # before the directory goes
    finally:
        os.chdir(cwd)
    check(sorted(r['method'] for r in rows) == sorted(baseline.METHODS)
          and all(r['split'] == 'val' and 0.0 <= r['miou'] <= 1.0
                  for r in rows), f'parity rows {rows}')
    check_launches(launches, V2_KERNELS + SCATTER, 'parity')
    print(f'[parity] cli.parity.main smoke mode, VOC2012 VGG16 at {SIZE}^2, '
          f'{PARITY_N} synthetic images: {dt:.2f} s wall in-process; '
          f'mIoU ' + ', '.join(f'{r["method"]} {r["miou"]:.5f}'
                               for r in rows)
          + f'; launches {launches} ({smi})')
    return {'parity': launches}


def phase_irn(torch, smi):
    """The irn phases: ({path: launches}, {kernel: {case: numbers}} of
    flat_color_blur at irn_voc's own grid)."""
    paths, handle, net, ips, cases = phase_irn_voc(torch, smi)
    paths.update(phase_irn_card_vs_cpu(torch, smi, handle, net))
    del net
    train_paths, train_ips = phase_irn_train(torch, smi, handle)
    paths.update(train_paths)
    ips.update(train_ips)
    del handle
    torch.cuda.empty_cache()
    paths.update(phase_cli_irn(torch, smi, ips))
    torch.cuda.empty_cache()
    paths.update(phase_irn_adp(torch, smi))
    return paths, cases


# --- multi-device inference on a mesh of shards ------------------------------
# Two shards on one card (Mesh([cuda:0, cuda:0])): the banding, the halo
# copies and every kernel of a band run on the card, but nothing runs in
# parallel, so the times measure what banding costs, not scaling.
MESH_DEVICE = 'cuda'
MESH_GRID_HW = 2448          # DeepGlobe's native size
MESH_WINDOW_HW = 2448
MESH_WALK_HW = (94, 125)     # irn_voc's walk grid: n = 11 750
MESH_CLI_SIZE = 0            # --img_size of mesh_cli (0: the model's own)
MESH_LABEL_FLOOR = 0.999     # K1's float atomics: labels may flip at ties
MESH_GRID_Q_TOL = 1e-3       # the banded grid against one device, max |dQ|
MESH_WINDOW_Q_TOL = 2e-4     # the banded window (tests/test_sharded_crf.py)
MESH_WALK_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_mxu_sharded.py


def mesh_device(torch):
    return (torch.device('cuda', 0) if MESH_DEVICE == 'cuda'
            else torch.device(MESH_DEVICE))


def mesh_problem(hw, c, seed):
    """A seeded image [hw, hw, 3] of flat 48-px blocks plus noise, and CRF
    probabilities [hw, hw, C] from 64-px blocks of logits plus noise:
    regions the CRF settles, so few labels sit at a tie."""
    rng = np.random.default_rng(seed)

    def blocks(cell, shape, draw):
        n = hw // cell + 1
        return np.kron(draw((n, n) + shape),
                       np.ones((cell, cell) + (1,) * len(shape)))[:hw, :hw]

    img = blocks(48, (3,), lambda s: rng.integers(0, 256, s))
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
    logits = 2 * blocks(64, (c,), rng.standard_normal)
    logits = logits + rng.standard_normal(logits.shape)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    return probs.astype(np.float32), img.astype(np.float32)


def mesh_hsn(torch, smi, mesh, fg, bg):
    """The main path's program on two shards: each runs the whole step on
    its 4 images (the grid route: the bg max is shard-local)."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods.hsn import HSNSegmenter
    spec = registry.get('VOC2012')
    seg = HSNSegmenter(spec, fg, bg, model_type='VGG16', device=fg.device)
    check(seg.per_shard(mesh), 'mesh_hsn does not take the per-shard step')
    imgs = np.random.default_rng(31).integers(
        0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    seg.segment_batch(imgs, mesh=mesh)                     # warm-up
    K.reset_launch_counts()
    labels, dt = timed(torch, lambda: seg.segment_batch(imgs, mesh=mesh))
    launches = dict(K.LAUNCHES)
    check_launches(launches, V2_KERNELS, 'mesh_hsn')
    want = 2 * (seg.cfg.iterations + 1)      # 11 filters a shard
    check(launches['bilateral_color_blur'] == want,
          f'mesh_hsn bilateral_color_blur launched '
          f'{launches["bilateral_color_blur"]} times, expected {want}')
    t_mesh, t_one = [dt], []
    for _ in range(2):
        t_one.append(timed(torch, lambda: seg.segment_batch(imgs))[1])
        t_mesh.append(timed(torch, lambda: seg.segment_batch(
            imgs, mesh=mesh))[1])
    half = BATCH // 2
    shards = torch.cat([seg.segment_batch(imgs[:half]),
                        seg.segment_batch(imgs[half:])])
    check(labels.shape == (BATCH, SIZE, SIZE) and labels.dtype == torch.int32,
          f'mesh_hsn labels {tuple(labels.shape)} {labels.dtype}')
    agree = float((labels == shards).float().mean())
    whole = float((labels == seg.segment_batch(imgs)).float().mean())
    ips, ips1 = BATCH / np.median(t_mesh), BATCH / np.median(t_one)
    print(f'[mesh_hsn] VOC2012 VGG16 fg + bg at {SIZE}^2, batch {BATCH} on '
          f'{mesh}: {ips:.2f} img/s (median of {len(t_mesh)}), one device '
          f'{ips1:.2f} img/s (median of {len(t_one)}); launches {launches} '
          f'({want // 2} filters a shard); labels against each shard\'s '
          f'images on one device {agree:.6f} (bound {MESH_LABEL_FLOOR}), '
          f'against the whole batch on one device (global bg max) '
          f'{whole:.6f} ({smi})')
    check(agree >= MESH_LABEL_FLOOR,
          f'mesh_hsn labels agree {agree} < {MESH_LABEL_FLOOR}')
    # K1-K3 against their plain versions at a shard's shape: the main
    # path's geometry at B 4 (counted apart from the launches read above)
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.meanfield import MXU_CELL_MULT
    gen = torch.Generator(device=fg.device).manual_seed(32)
    guide = path_guide(torch, 'hsn', gen)[:half]
    geo = mxu_grid.MXUBilateralGrid(guide, 8.0, 13.0, 21,
                                    cell_mult=MXU_CELL_MULT)
    check(geo.v2 and (geo.t, geo.gy, geo.gx, geo.gc) == (8, 9, 9, 16),
          f'mesh_hsn shard geometry {(geo.v2, geo.t, geo.gy, geo.gx, geo.gc)}')
    x = torch.rand((half, GUIDE, GUIDE, 21), generator=gen,
                   device=fg.device)
    cases = v2_cases(torch, K, geo, x,
                     f'mesh_hsn shard B={half} {GUIDE}x{GUIDE} C=21')[0]
    return launches, {name: {f'mesh_hsn_b{half}_c21': r}
                      for name, r in cases.items()}


def mesh_grid(torch, smi, mesh):
    """mxu_sharded.mean_field_sharded on one DeepGlobe-sized image at
    hsn_config('DeepGlobe') (bi_sxy 40: t 40, halo 320) against the
    single-device grid mean field at the same geometry (full resolution,
    colour cells of srgb)."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import config, meanfield, mxu_sharded
    cfg = config.hsn_config('DeepGlobe')
    c = registry.get('DeepGlobe').n_fg_classes - 1    # drop_last_class
    hw = MESH_GRID_HW
    probs, img = mesh_problem(hw, c, seed=33)
    dev = mesh_device(torch)
    probs, img = torch.from_numpy(probs).to(dev), torch.from_numpy(img).to(dev)
    K.reset_launch_counts()
    q_sh, dt0 = timed(torch, lambda: mxu_sharded.mean_field_sharded(
        probs, img, cfg, mesh))
    launches = dict(K.LAUNCHES)
    check_launches(launches, V2_KERNELS, 'mesh_grid')
    want = mesh.shape['data'] * (cfg.iterations + 1)
    check(launches['bilateral_color_blur'] == want,
          f'mesh_grid bilateral_color_blur launched '
          f'{launches["bilateral_color_blur"]} times, expected {want}')
    dt_sh = timed(torch, lambda: mxu_sharded.mean_field_sharded(
        probs, img, cfg, mesh))[1]
    kw = dict(g_sxy=cfg.g_sxy, g_compat=cfg.g_compat, bi_sxy=cfg.bi_sxy,
              bi_srgb=cfg.bi_srgb, bi_compat=cfg.bi_compat,
              iterations=cfg.iterations, cell_mult=1.0)
    prev = meanfield._MXU_DS_DISABLED
    meanfield._MXU_DS_DISABLED = True       # full resolution, as the bands
    try:
        q_1, dt1 = timed(torch, lambda: meanfield._mean_field_mxu(
            probs[None], img[None], **kw)[0])
        dt1 = min(dt1, timed(torch, lambda: meanfield._mean_field_mxu(
            probs[None], img[None], **kw)[0])[1])
    finally:
        meanfield._MXU_DS_DISABLED = prev
    err = float((q_sh - q_1).abs().max())
    agree = float((q_sh.argmax(-1) == q_1.argmax(-1)).float().mean())
    t, halo = mxu_sharded._halo_px(cfg.bi_sxy)
    n = mesh.shape['data']
    rows = -(-hw // (n * t)) * t
    print(f'[mesh_grid] {hw}x{hw}, C {c}, {cfg}: {n} bands of {rows} rows '
          f'+ 2 x {halo} halo = {rows + 2 * halo} (band rows / image rows '
          f'{n * (rows + 2 * halo) / hw:.3f}); launches {launches} '
          f'({want // n} filters a band); {1e3 * dt_sh:.1f} ms (first call '
          f'{1e3 * dt0:.1f}), one device {1e3 * dt1:.1f} ms; max |dQ| '
          f'{err:.3g} (bound {MESH_GRID_Q_TOL}), labels {agree:.6f} (bound '
          f'{MESH_LABEL_FLOOR}) ({smi})')
    check(torch.isfinite(q_sh).all() and q_sh.shape == (hw, hw, c),
          'mesh_grid Q not finite or misshapen')
    check(err <= MESH_GRID_Q_TOL and agree >= MESH_LABEL_FLOOR,
          f'mesh_grid against one device: |dQ| {err}, labels {agree}')
    # K1-K3 against their plain versions at this path's own shapes, apart
    # from the launches read above: the last band's grid (it holds the
    # padded rows) on its message input (Q times the validity) and on the
    # normalizer's (the validity), and the single-device grid at hw^2
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.sharded import _exchange_halo

    def last_band(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n * rows - hw))
        return _exchange_halo([x[i * rows:(i + 1) * rows]
                               for i in range(n)], halo)[-1][None]
    v_b = last_band(torch.ones((hw, hw, 1), device=dev))
    geo = mxu_grid.MXUBilateralGrid(last_band(img), cfg.bi_sxy, cfg.bi_srgb,
                                    c)
    check(geo.v2 and geo.bhw == (1, rows + 2 * halo, hw)
          and (geo.t, geo.gy, geo.gx, geo.gc) == (40, 48, 63, 21),
          f'mesh_grid band geometry '
          f'{(geo.v2, geo.bhw, geo.t, geo.gy, geo.gx, geo.gc)}')
    cases = {}
    for x, case in ((last_band(probs) * v_b, f'mesh_grid_c{c}'),
                    (v_b, 'mesh_grid_c1')):
        label = (f'{case} band {rows + 2 * halo}x{hw} grid '
                 f'{geo.gy}x{geo.gx}x{geo.gc}^3')
        for name, r in v2_cases(torch, K, geo, x, label)[0].items():
            cases.setdefault(name, {})[case] = r
    geo = mxu_grid.MXUBilateralGrid(img[None], cfg.bi_sxy, cfg.bi_srgb, c,
                                    cell_mult=1.0)
    check(geo.v2, 'mesh_grid: the single-device grid left the v2 route')
    label = (f'mesh_grid_one_c{c} {hw}x{hw} grid '
             f'{geo.gy}x{geo.gx}x{geo.gc}^3')
    for name, r in v2_cases(torch, K, geo, probs[None], label)[0].items():
        cases[name][f'mesh_grid_one_c{c}'] = r
    return launches, cases


def mesh_window(torch, smi, mesh):
    """sharded.mean_field_sharded at HSN_TEST[('VOC2012', 'M7')] (81
    offsets, halo 10) against the single-device window and Gaussian
    message (the oracle of tests/test_sharded_crf.py)."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.ops.crf import config, meanfield, sharded
    from wsss_tpu_torch.parallel.mesh import Mesh
    cfg = config.HSN_TEST[('VOC2012', 'M7')]
    hw, c = MESH_WINDOW_HW, 21
    probs, img = mesh_problem(hw, c, seed=35)
    dev = mesh_device(torch)
    probs, img = torch.from_numpy(probs).to(dev), torch.from_numpy(img).to(dev)
    K.reset_launch_counts()
    q_sh, dt_sh = timed(torch, lambda: sharded.mean_field_sharded(
        probs, img, cfg, mesh))
    launches = dict(K.LAUNCHES)
    check_launches(launches, (), 'mesh_window')

    filt = meanfield.DirectBilateral(img, cfg.bi_sxy, cfg.bi_srgb)

    def single():
        U = -torch.log(torch.clamp(probs, min=1e-10))
        Q = torch.softmax(-U, -1)
        nb = torch.rsqrt(torch.clamp(filt.filter(
            torch.ones((hw, hw, 1), device=dev)), min=1e-20))
        for _ in range(cfg.iterations):
            mb = nb * filt.filter(nb * Q) - nb * nb * Q
            mg = meanfield.gaussian_message(Q, cfg.g_sxy)
            Q = torch.softmax(-U + cfg.g_compat * mg + cfg.bi_compat * mb,
                              -1)
        return Q

    q_1, dt1 = timed(torch, single)
    err = float((q_sh - q_1).abs().max())
    flips = int((q_sh.argmax(-1) != q_1.argmax(-1)).sum())
    # what the check can see at the cut: the rows within one halo of it,
    # how many of them hold a Q that is not saturated, and how far bands
    # that received no halo rows (each half alone) land from one device
    n = mesh.shape['data']
    cut = hw // n
    halo = 2 * max(int(np.ceil(3 * cfg.bi_sxy)),
                   max(1, int(np.ceil(4 * cfg.g_sxy))))
    near = slice(cut - halo, cut + halo)
    err_near = float((q_sh[near] - q_1[near]).abs().max())
    soft = float(((q_1[near] > 1e-6) & (q_1[near] < 1 - 1e-6)).any(-1)
                 .float().mean())
    one = Mesh([dev], ('data',))
    q_cut = torch.cat([sharded.mean_field_sharded(
        probs[i * cut:(i + 1) * cut], img[i * cut:(i + 1) * cut], cfg, one)
        for i in range(n)])
    err_cut = float((q_cut[near] - q_1[near]).abs().max())
    print(f'[mesh_window] {hw}x{hw}, C {c}, {cfg}: {len(filt.offs)} '
          f'offsets; {1e3 * dt_sh:.1f} ms on {n} bands, one device '
          f'{1e3 * dt1:.1f} ms; max |dQ| {err:.3g} (bound '
          f'{MESH_WINDOW_Q_TOL}), within {halo} rows of the cut '
          f'{err_near:.3g}, {flips} labels differ; pixels there with a Q '
          f'in (1e-6, 1 - 1e-6) {soft:.4f}; bands without halos: |dQ| '
          f'{err_cut:.3g} there; no hand kernel ({smi})')
    check(err <= MESH_WINDOW_Q_TOL and flips == 0,
          f'mesh_window against one device: |dQ| {err}, {flips} flips')
    check(soft >= 0.99 and err_cut > 100 * MESH_WINDOW_Q_TOL,
          f'mesh_window cannot see a halo fault: soft {soft}, bands '
          f'without halos {err_cut}')
    return launches


def mesh_walk(torch, smi):
    """propagate_to_edge_sharded on a (2, 1) mesh at irn_voc's walk size
    against propagate_to_edge; then make_sem_seg(mesh=) against
    make_sem_seg, labels equal."""
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.ops import random_walk
    from wsss_tpu_torch.ops.crf.config import IRN_TUNED
    from wsss_tpu_torch.parallel.mesh import Mesh
    dev = mesh_device(torch)
    wmesh = Mesh(np.array([[dev], [dev]], dtype=object), ('data', 'model'))
    exp = IRN_TUNED[('VOC2012', 'VGG16')][1]
    h, w = MESH_WALK_HW
    n = h * w
    rng = np.random.default_rng(37)
    cam = rng.random((3, h, w)).astype(np.float32) * 0.3
    cam[0, :, : w // 3] += 0.7
    cam[1, :, w // 3:] += 0.5
    cam[2, h // 2:] += 0.6
    edge = (rng.random((h, w)) * 0.5).astype(np.float32)
    edge[:, w // 2] = 0.9
    cam_t = torch.from_numpy(cam).to(dev)
    edge_t = torch.from_numpy(edge).to(dev)
    kw = dict(beta=10.0, exp_times=exp, radius=5)
    # warm-up: the first call allocates the blocks (cudaMalloc) and reads
    # 0.8 s on an H100 where a warm one reads ~0.59 s (PERF.md §6)
    random_walk.propagate_to_edge_sharded(cam_t, edge_t, wmesh, **kw)
    K.reset_launch_counts()
    out_sh, dt_sh = timed(torch, lambda: random_walk.propagate_to_edge_sharded(
        cam_t, edge_t, wmesh, **kw))
    launches = dict(K.LAUNCHES)
    check_launches(launches, (), 'mesh_walk')
    out_1, dt1 = timed(torch, lambda: random_walk.propagate_to_edge(
        cam_t, edge_t, **kw))
    err = float((out_sh - out_1).abs().max())
    close = bool(torch.allclose(out_sh, out_1, **MESH_WALK_TOL))
    d = {'keys': np.array([0, 2, 4]), 'cam': cam, 'high_res': cam}
    orig = (375, 500)
    lab_sh = irnet.make_sem_seg(edge_t, d, 'VOC2012', orig, beta=10.0,
                                exp_times=exp, mesh=wmesh, device=dev)
    lab_1 = irnet.make_sem_seg(edge_t, d, 'VOC2012', orig, beta=10.0,
                               exp_times=exp, device=dev)
    flops = 2.0 * n ** 3 * exp
    print(f'[mesh_walk] n {n} ({h}x{w}), exp_times {exp}, on {wmesh}: '
          f'{1e3 * dt_sh:.1f} ms = {flops / dt_sh / 1e12:.2f} TFLOP/s, one '
          f'device {1e3 * dt1:.1f} ms = {flops / dt1 / 1e12:.2f} TFLOP/s '
          f'({flops:.4g} flops); max |d| {err:.3g}, allclose '
          f'{MESH_WALK_TOL} {close}; make_sem_seg labels equal '
          f'{bool(np.array_equal(lab_sh, lab_1))} ({smi})')
    check(close, f'mesh_walk against one device: max |d| {err}')
    check(np.array_equal(lab_sh, lab_1) and lab_sh.shape == orig,
          'mesh_walk: make_sem_seg labels differ from one device\'s')
    return launches


def mesh_cues(torch, smi, mesh, fg, bg):
    """VOCDeepGlobeCueGenerator.run(mesh=) over 16 synthetic VOC images in
    batches of BATCH, placed by mesh_batches' prefetch thread: the cues
    equal the unsharded run's; no hand kernel."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods.gradcam_cues import VOCDeepGlobeCueGenerator
    spec = registry.get('VOC2012')
    gen = VOCDeepGlobeCueGenerator(spec, fg, bg, device=fg.device)
    ds = SyntheticWSSS('VOC2012', size=SIZE, n_images=16)
    single = gen.run(ds.batches(BATCH))                     # warm-up
    K.reset_launch_counts()
    sharded, dt = timed(torch, lambda: gen.run(ds.batches(BATCH), mesh=mesh))
    launches = dict(K.LAUNCHES)
    check_launches(launches, (), 'mesh_cues')
    dt1 = timed(torch, lambda: gen.run(ds.batches(BATCH)))[1]
    same = (set(sharded) == set(single)
            and all(np.array_equal(sharded[k], single[k]) for k in single))
    print(f'[mesh_cues] 16 VOC images at {SIZE}^2 in batches of {BATCH} on '
          f'{mesh}: {16 / dt:.2f} img/s, one device {16 / dt1:.2f} img/s; '
          f'cues equal the unsharded run\'s: {same} ({smi})')
    check(same, 'mesh_cues: the sharded cues differ from the unsharded')
    return launches


def read_tree(root):
    """{relative path: contents} of every file under root: the bytes, or
    for an .xlsx (whose zip entries carry the time of writing) its
    table."""
    import os
    from wsss_tpu_torch.eval import xlsx
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            if f.endswith('.xlsx'):
                body = xlsx.read_table_xlsx(path)
            else:
                with open(path, 'rb') as fh:
                    body = fh.read()
            out[os.path.relpath(path, root)] = body
    return out


# --mesh auto against --mesh none, checkpoints, both trained with torch's
# deterministic algorithms: without them two --mesh none runs differ by
# more than the mesh could (on an H100 80GB HBM3 at 700 W,
# cli.train_classifier's momentum buffers by 3% of their size, the
# classifier's random-weight gradient amplifying the order of cuDNN's
# atomic sums; with cuDNN's deterministic algorithms alone, cli.irn's
# disp_mean by 1.1e-6, from the atomics of the heads' upsampling
# backward; PERF.md)
MESH_CKPT_TOL = 1e-6


def ckpt_tensors(root):
    """{path in the state: tensor} of the latest checkpoint under root."""
    from wsss_tpu_torch.io import checkpoint
    state, _ = checkpoint.restore_checkpoint(root, map_location='cpu')
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f'{prefix}/{k}', x)
        elif hasattr(v, 'is_floating_point'):
            out[prefix] = v
    walk('', state)
    return out


def ckpt_diff(a, b):
    """(max |a - b| over two checkpoints' tensors, the tensor where it
    falls); inf if their keys differ."""
    if a.keys() != b.keys() or not a:
        return float('inf'), None
    return max((float((a[k].double() - b[k].double()).abs().max()), k)
               for k in a)


def mesh_cli(torch, smi):
    """cli.gen_cues, cli.hsn and cli.irn (make_cam, cam_to_ir_label,
    make_sem_seg) with --mesh auto (a one-shard mesh on one card) against
    --mesh none: the same files; then the training command lines
    (cli.train_classifier, cli.sec_dsrg --task train, cli.irn --passes
    train_irn) with --mesh auto against --mesh none, each pair trained
    with torch's deterministic algorithms: checkpoints within
    MESH_CKPT_TOL.  Launches are those of the --mesh auto runs."""
    import os
    import shutil
    import tempfile
    from wsss_tpu_torch.cli import gen_cues, hsn as hsn_cli, irn as irn_cli
    from wsss_tpu_torch.cli import sec_dsrg as sec_cli
    from wsss_tpu_torch.cli import train_classifier
    base = ['--dataset', 'VOC2012', '--model', 'VGG16', '--device',
            MESH_DEVICE, '--img_size', str(MESH_CLI_SIZE), '--batchsize',
            str(BATCH)]
    irn_passes = 'make_cam,cam_to_ir_label,make_sem_seg'
    runs = {'gen_cues': (gen_cues.main, ['--task', 'gen'], 'cues'),
            'hsn': (hsn_cli.main, [], 'eval'),
            'irn': (irn_cli.main, ['--passes', irn_passes], 'irn')}
    total, secs = {}, {}
    cwd = os.getcwd()
    try:
        with MissingWriters('mesh_cli'), \
                tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            run_cli(torch, irn_cli.main, base + [      # the IRNet to restore
                '--passes', 'make_cam,cam_to_ir_label,train_irn',
                '--work_root', 'irn_none'])
            ckpt = os.path.join('IRN_VOC2012_VGG16', 'irn_ckpt')
            shutil.copytree(os.path.join('irn_none', ckpt),
                            os.path.join('irn_auto', ckpt))
            for name, (main, extra, root) in runs.items():
                files = {}
                for mesh in ('none', 'auto'):
                    at = f'{root}_{mesh}'
                    argv = base + extra + ['--mesh', mesh]
                    argv += {'gen_cues': ['--cues_root', at],
                             'hsn': ['--eval_root', at],
                             'irn': ['--work_root', at]}[name]
                    _, _, dt, launches = run_cli(torch, main, argv)
                    files[mesh] = {k: v for k, v in read_tree(at).items()
                                   if 'irn_ckpt' not in k}
                secs[name] = dt
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                same = files['none'] == files['auto']
                print(f'[mesh_cli] cli.{name} --mesh auto: {dt:.2f} s '
                      f'in-process, {len(files["auto"])} files, equal to '
                      f'--mesh none\'s: {same}; launches '
                      f'{ {k: v for k, v in launches.items() if v} } ({smi})')
                check(same and files['auto'],
                      f'mesh_cli: cli.{name} --mesh auto wrote other files')
            # training: irn_auto holds the --mesh auto run's ir-labels, the
            # same files as irn_none's
            train = {
                'train_classifier': (
                    train_classifier.main, ['--epochs', '1'],
                    lambda m: ['--model_root', f'models_{m}', '--eval_root',
                               f'eval_{m}'],
                    lambda m: os.path.join(f'models_{m}', 'VOC2012_VGG16',
                                           'ckpt')),
                'sec_dsrg': (
                    sec_cli.main, ['--task', 'train', '--method', 'SEC',
                                   '--epochs', '1', '--val_every', '0'],
                    lambda m: ['--wsss_model_root', f'wsss_{m}'],
                    lambda m: os.path.join(f'wsss_{m}',
                                           'SEC_VOC2012_VGG16')),
                'irn': (
                    irn_cli.main, ['--passes', 'train_irn'],
                    lambda m: ['--work_root', f'irn_{m}'],
                    lambda m: os.path.join(f'irn_{m}', ckpt))}
            deterministic = (torch.backends.cudnn.deterministic,
                             torch.are_deterministic_algorithms_enabled())
            torch.backends.cudnn.deterministic = True
            # warn_only: cuBLAS on the one stream the shards share is
            # deterministic without CUBLAS_WORKSPACE_CONFIG
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for name, (main, extra, where, ckpt_of) in train.items():
                    states, dts = {}, {}
                    for mesh in ('none', 'auto'):
                        _, _, dts[mesh], launches = run_cli(
                            torch, main, base + extra + where(mesh)
                            + ['--mesh', mesh])
                        check_launches(launches, (), f'mesh_cli {name} '
                                       f'--mesh {mesh} (no hand kernel)')
                        states[mesh] = ckpt_tensors(ckpt_of(mesh))
                    err, at = ckpt_diff(states['auto'], states['none'])
                    print(f'[mesh_cli] cli.{name} training --mesh auto: '
                          f'{dts["auto"]:.2f} s in-process (--mesh none '
                          f'{dts["none"]:.2f} s), deterministic algorithms; '
                          f'checkpoint ({len(states["auto"])} tensors) '
                          f'against --mesh none\'s: max |d| {err:.3g} at '
                          f'{at} (tolerance {MESH_CKPT_TOL}) ({smi})')
                    check(err <= MESH_CKPT_TOL,
                          f'mesh_cli: cli.{name} --mesh auto trained another '
                          f'checkpoint (max |d| {err} at {at})')
            finally:
                torch.backends.cudnn.deterministic = deterministic[0]
                torch.use_deterministic_algorithms(deterministic[1])
            os.chdir(cwd)                 # before the directory goes
    finally:
        os.chdir(cwd)
    check_launches(total, V2_KERNELS + SCATTER, 'mesh_cli')
    return total


def phase_mesh(torch, smi):
    """The multi-device inference path on Mesh([cuda:0, cuda:0]): each
    case with the launch counts set to 0 just before and read after;
    returns those counts and K1-K3's cases at the mesh paths' shapes."""
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.parallel.mesh import Mesh
    dev = mesh_device(torch)
    mesh = Mesh([dev, dev], ('data',))
    n = registry.get('VOC2012').n_fg_classes
    fg = _ClassifierHandle.random('VGG16', n, SIZE, seed=0, device=dev)
    bg = _ClassifierHandle.random('VGG16', n, SIZE, seed=1, device=dev)
    paths, cases = {}, {}
    paths['mesh_hsn'], hsn_cases = mesh_hsn(torch, smi, mesh, fg, bg)
    paths['mesh_cues'] = mesh_cues(torch, smi, mesh, fg, bg)
    del fg, bg
    paths['mesh_grid'], grid_cases = mesh_grid(torch, smi, mesh)
    torch.cuda.empty_cache()
    for name in V2_KERNELS:
        cases[name] = dict(hsn_cases[name], **grid_cases[name])
    paths['mesh_window'] = mesh_window(torch, smi, mesh)
    paths['mesh_walk'] = mesh_walk(torch, smi)
    paths['mesh_cli'] = mesh_cli(torch, smi)
    return paths, cases


# --- data-parallel training on a mesh of shards ------------------------------
# Mesh([cuda:0, cuda:0]) again: the two shards' forwards run in two host
# threads on the one card, so the img/s measure what the step over the
# shards costs (its meetings, the second replica, the gradient sum), not
# scaling.  Each trainer's step over the two shards is held against its
# one-device step from the same weights and generator (the same dropout
# masks): the loss within TRAIN_LOSS_RTOL, and the change the step made to
# the parameters, d_mesh against d_one, by ||d_mesh - d_one|| / ||d_one||
# over all parameters within MESH_TRAIN_REL (the same for the buffers,
# BatchNorm's running statistics, where the step moves any).  A step on
# the first half of the batch alone, what shards whose gradients were
# never summed would give, must read above MESH_TRAIN_REL: the check sees
# a missing reduction.  The classifier's held step runs in float64
# (MESH_TRAIN_CLS_HELD): in float32 the VGG16 (BN) update at 321^2 is
# not determined beyond its rounding (scripts/dp_step_diag.py reads the
# float32 step against the float64 one), so two orders of the same sums
# part it; its float32 loss is held on the timed steps' first.
MESH_TRAIN_STEPS = 3         # timed steps after the held one
MESH_TRAIN_REL = 1e-3
MESH_TRAIN_CLS_HELD = 'float64'


def state_clone(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def phase_mesh_train(torch, smi):
    """mesh_train_cls (ClassifierTrainer, VGG16 with BN, VOC's 20 classes,
    321^2, batch 8 as two shards of 4), mesh_train_sec and one DSRG step
    (DeepLab at 321^2, 21 classes, the CLI's synthetic cues),
    mesh_train_irn (IRNet vgg16 at crop 320, radius 10, irn_train_voc's
    batch): each one step over Mesh([cuda:0, cuda:0]) against one
    device's, then MESH_TRAIN_STEPS timed steps each way."""
    from wsss_tpu_torch.cli.sec_dsrg import _synthetic_cues
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.models.backbones import build_classifier, init_random
    from wsss_tpu_torch.parallel.mesh import Mesh
    from wsss_tpu_torch.train.classifier import ClassifierTrainer
    from wsss_tpu_torch.train.sec_dsrg import SECDSRGTrainer
    dev = mesh_device(torch)
    mesh = Mesh([dev, dev], ('data',))
    spec = registry.get('VOC2012')
    b = next(SyntheticWSSS('VOC2012', size=SIZE, n_images=BATCH)
             .batches(BATCH, with_gt=True))
    raw = torch.as_tensor(b.images, device=dev)
    tags = torch.as_tensor(b.tags, device=dev)
    gen = torch.Generator(dev)
    paths, ips_of = {}, {}

    def change(mod, before):
        """{name: state after - before} of the tensors in ``before``."""
        now = dict(mod.named_parameters())
        now.update(mod.named_buffers())
        return {k: now[k].detach().double() - v for k, v in before.items()}

    def rel(got, want):
        """(||got - want|| / ||want|| over all tensors, the worst tensor and
        its own ratio); None where neither step moved anything."""
        num = den = 0.0
        worst = (0.0, '-')
        for k, w in want.items():
            e, dw = float((got[k] - w).norm()), float(w.norm())
            num, den = num + e * e, den + dw * dw
            if dw > 0:
                worst = max(worst, (e / dw, k))
        if den == 0:
            return None if num == 0 else (float('inf'), worst[1], worst[0])
        return (num / den) ** 0.5, worst[1], worst[0]

    def held(name, what, make, step, module_of, loss_key, dtype):
        """One step on fresh trainers from the same weights: one device,
        over the shards, and one device on the first half of the batch.
        Returns the first two's losses."""
        runs = {}
        for key, m, n in (('one', None, BATCH), ('mesh', mesh, BATCH),
                          ('half', None, BATCH // 2)):
            tr = make(dtype)
            mod = module_of(tr)
            before = {k: v.detach().double().clone()
                      for k, v in mod.state_dict().items()
                      if v.is_floating_point()}
            first = {k: float(v) for k, v in step(tr, 0, m, n).items()}
            runs[key] = (first, change(mod, before),
                         {k for k, _ in mod.named_parameters()})
            del tr, mod, before
            torch.cuda.empty_cache()
        first_one, d_one, names = runs['one']
        first_mesh, d_mesh, _ = runs['mesh']
        d_half = runs['half'][1]
        params = {k: v for k, v in d_one.items() if k in names}
        buffers = {k: v for k, v in d_one.items() if k not in names}
        r_p = rel({k: d_mesh[k] for k in params}, params)
        r_h = rel({k: d_half[k] for k in params}, params)
        r_b = rel({k: d_mesh[k] for k in buffers}, buffers)
        l1, l2 = first_one[loss_key], first_mesh[loss_key]
        bufs = ('no buffer moved' if r_b is None else
                f'buffers {r_b[0]:.3g} (worst {r_b[1]} {r_b[2]:.3g})')
        print(f'[mesh_train] {name} {what} in {dtype}: one step over {mesh} '
              f'against one device from the same weights and masks: '
              f'{loss_key} {l2:.9g} vs {l1:.9g} (rtol {TRAIN_LOSS_RTOL}); '
              f'||d_mesh - d_one|| / ||d_one||: parameters {r_p[0]:.3g} '
              f'(worst {r_p[1]} {r_p[2]:.3g}), {bufs} (bound '
              f'{MESH_TRAIN_REL}); a step on the first half of the batch '
              f'reads {r_h[0]:.3g} ({smi})')
        check(abs(l2 - l1) <= TRAIN_LOSS_RTOL * abs(l1),
              f'{name}: the step over the shards has another loss')
        check(r_p[0] <= MESH_TRAIN_REL,
              f'{name}: the step over the shards updated other parameters')
        check(r_b is None or r_b[0] <= MESH_TRAIN_REL,
              f'{name}: the step over the shards moved other statistics')
        check(r_h[0] > MESH_TRAIN_REL,
              f'{name}: a half-batch step passes the bound, which then '
              f'cannot see a missing gradient sum')
        return {'one': first_one, 'mesh': first_mesh}

    def run(name, what, make, step, module_of, loss_key, timed=True,
            dtype=torch.float32):
        """The held first step (on fresh trainers, in ``dtype``), then,
        where timed, the timed float32 ones, whose first losses (from the
        same weights and masks) agree within TRAIN_LOSS_RTOL.  Returns
        (launches, the held step's losses one way and the other)."""
        K.reset_launch_counts()
        firsts = held(name, what, make, step, module_of, loss_key, dtype)
        launches = dict(K.LAUNCHES)
        check_launches(launches, (), f'{name} (no hand kernel)')
        if not timed:
            return launches, firsts
        timing = {}
        for key, m in (('one', None), ('mesh', mesh)):
            tr = make(torch.float32)
            if key == 'mesh':
                K.reset_launch_counts()
            parts, ips, peak = train_loop(
                torch, lambda i: step(tr, i, m, BATCH), BATCH,
                1 + MESH_TRAIN_STEPS)
            if key == 'mesh':
                for k, v in K.LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + v
            timing[key] = (ips, peak, parts[0][loss_key])
            del tr
            torch.cuda.empty_cache()
        (ips1, peak1, l1), (ips2, peak2, l2) = timing['one'], timing['mesh']
        print(f'[mesh_train] {name} {what}, batch {BATCH}, '
              f'{MESH_TRAIN_STEPS} steps after a warm-up: {ips2:.2f} img/s '
              f'over 2 shards on one card, one device {ips1:.2f} img/s '
              f'({ips2 / ips1:.3f}x); peak memory {peak2:.2f} GiB, one '
              f'device {peak1:.2f} GiB; first float32 {loss_key} {l2:.9g} vs '
              f'{l1:.9g}; launches '
              f'{ {k: v for k, v in launches.items() if v} } ({smi})')
        check(abs(l2 - l1) <= TRAIN_LOSS_RTOL * abs(l1),
              f'{name}: the float32 step over the shards has another loss')
        check_launches(launches, (), f'{name} (no hand kernel)')
        ips_of[name] = ips2
        return launches, firsts

    # --- VGG16 (BN) classifier, dropout on, lr 0.01 ----------------------
    x = _normalizer(spec.norm_cues, dev)(raw)

    def make_cls(dtype):
        net = build_classifier('VGG16', spec.n_fg_classes, dtype=dtype)
        tr = ClassifierTrainer(net.to(dtype), lr=0.01, schedule='const',
                               device=dev)
        tr.init(torch.Generator().manual_seed(0))
        return tr
    paths['mesh_train_cls'], _ = run(
        'mesh_train_cls', f'VGG16 (BN) at {SIZE}^2', make_cls,
        lambda tr, i, m, n: tr.train_step(x[:n], tags[:n],
                                          gen.manual_seed(i), mesh=m),
        lambda tr: tr.model, 'loss', dtype=getattr(torch, MESH_TRAIN_CLS_HELD))

    # --- SEC, then one DSRG step: DeepLab at 321^2, 21 classes ----------
    xs = _normalizer(spec.norm_sec, dev)(raw)
    n_seg = spec.n_seg_classes
    grid = (SIZE - 1) // 8 + 1
    cues = []
    for i in range(MESH_TRAIN_STEPS + 1):
        c, lab = _synthetic_cues(b.gt, n_seg, grid, i)
        cues.append((torch.as_tensor(c, device=dev),
                     torch.as_tensor(lab, device=dev)))

    def make_deeplab(method):
        def make(dtype):
            tr = SECDSRGTrainer(method, n_seg, device=dev)
            tr.init(torch.Generator().manual_seed(0))
            return tr
        return make

    def deeplab_step(tr, i, m, n):
        return tr.train_step(xs[:n], raw[:n], *(c[:n] for c in cues[i]),
                             gen.manual_seed(i), mesh=m)
    paths['mesh_train_sec'], _ = run(
        'mesh_train_sec', f'SEC DeepLab at {SIZE}^2', make_deeplab('SEC'),
        deeplab_step, lambda tr: tr.net, 'total')
    paths['mesh_train_dsrg'], firsts = run(
        'mesh_train_dsrg', f'DSRG DeepLab at {SIZE}^2', make_deeplab('DSRG'),
        deeplab_step, lambda tr: tr.net, 'total', timed=False)
    grown = [firsts[k]['grown_px'] for k in ('mesh', 'one')]
    print(f'[mesh_train] mesh_train_dsrg grown_px {grown[0]:.0f} over the '
          f'shards, {grown[1]:.0f} on one device ({smi})')
    check(grown[0] == grown[1],
          'mesh_train_dsrg: the region growing grew other cues')

    # --- IRNet vgg16 at crop 320 on irn_train_voc's batch -----------------
    crop = SIZE // 16 * 16

    def make_irn(dtype):
        tr = irnet.IRNTrainer('vgg16', crop_size=crop, device=dev)
        tr.init(torch.Generator().manual_seed(1))
        init_random(tr.net.trunk, torch.Generator().manual_seed(5))
        return tr
    probe = make_irn(torch.float32)
    imgs, labels, _ = irn_train_batch(21, IRN_TRAIN_BATCH, crop, n_seg,
                                      probe.path_index)
    radius = probe.path_index.radius
    del probe
    xn = _normalizer(spec.norm_irn, dev)(
        torch.from_numpy(imgs).to(dev, torch.float32))
    dev_labels = [torch.from_numpy(a).to(dev) for a in labels]
    paths['mesh_train_irn'], _ = run(
        'mesh_train_irn', f'IRNet vgg16 at crop {crop}, radius {radius}',
        make_irn, lambda tr, i, m, n: tr.train_step(
            xn[:n], *(a[:n] for a in dev_labels), mesh=m),
        lambda tr: tr.net, 'total')
    return paths, ips_of


def main():
    import torch
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    results = phase_kernels(torch)
    phase_kernels_v1(torch, results)
    phase_kernels_scatter(torch, results)
    phase_kernels_aligned(torch, results)
    fixed_costs(torch, results)
    print(f'[time] kernels done at {time.perf_counter() - t_start:.0f} s')
    paths = {'hsn': phase_main(torch)}
    print(f'[time] main path done at {time.perf_counter() - t_start:.0f} s')
    paths.update(phase_cues(torch))
    print(f'[time] cues done at {time.perf_counter() - t_start:.0f} s')
    paths.update(phase_precision(torch, paths['hsn']))
    print(f'[time] precision done at {time.perf_counter() - t_start:.0f} s')
    paths.update(phase_sec(torch))
    paths.update(phase_wide(torch))
    paths.update(phase_irn_label(torch))
    paths.update(phase_adp_hsn(torch, results))
    paths.update(phase_aligned(torch))
    print(f'[time] aligned done at {time.perf_counter() - t_start:.0f} s')
    paths.update(phase_cli(torch))
    print(f'[time] cli done at {time.perf_counter() - t_start:.0f} s')
    paths.update(phase_train(torch))
    print(f'[time] train done at {time.perf_counter() - t_start:.0f} s')
    irn_paths, irn_cases = phase_irn(torch, smi)
    paths.update(irn_paths)
    for name, cases in irn_cases.items():
        results[name]['cases'].update(cases)
    print(f'[time] irn done at {time.perf_counter() - t_start:.0f} s')
    torch.cuda.empty_cache()
    paths.update(phase_parity(torch, smi))
    print(f'[time] parity done at {time.perf_counter() - t_start:.0f} s')
    torch.cuda.empty_cache()
    mesh_paths, mesh_cases = phase_mesh(torch, smi)
    paths.update(mesh_paths)
    for name, cases in mesh_cases.items():
        results[name]['cases'].update(cases)
    print(f'[time] mesh done at {time.perf_counter() - t_start:.0f} s')
    torch.cuda.empty_cache()
    mesh_train_paths, _ = phase_mesh_train(torch, smi)
    paths.update(mesh_train_paths)
    print(f'[time] mesh_train done at {time.perf_counter() - t_start:.0f} s')
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
            'wsss_tpu/ops/crf/pallas_blur.py:84 (call :110)',
        'direct_window': 'none (wsss_tpu/ops/crf/meanfield.py:'
                         'DirectBilateral is plain jnp)'}
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
            **{k: r[k] for k in ('shape', 'cases', 'device_ms',
                                 'library_device_ms', 'fixed_ms',
                                 'color_blur_ms', 'gc52_ms') if k in r}))
    print('kernels launched on the paths: '
          + ', '.join(k['name'] for k in kernels))
    print(f'[result] card: {smi}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))

if __name__ == '__main__':
    sys.exit(main())
