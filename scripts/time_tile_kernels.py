#!/usr/bin/env python3
"""Device time of the v1 route's tile splat, fold and cube blurs, of the
slice and of the aligned slice of one tree of wsss_tpu_torch, on one
CUDA card, beside their yardsticks.

    python3 scripts/time_tile_kernels.py [--tree DIR] [--only NAME ...]

Imports wsss_tpu_torch from DIR (default: this repository; another
checkout, such as a `git archive` of an earlier commit, compares two
versions of the kernels on one card), builds its kernels, and times at
the shapes chip_smoke.py gives them:
  * bilateral_splat_tiles (K4) on SEC prediction's v1 guide (B 1, 38x50,
    5x7 ragged tiles; C 21, C 1), the wide path's (B 2, 32x32; C 40,
    C 1) and the batch-8 guide (64x64; C 21, C 40), against one
    ``zeros().index_add_`` into the partial layout, and a plain
    ``fill_`` of the partials' bytes (how fast the card writes them);
  * bilateral_slice_aligned (K10) at batch 8, 321^2, t 20, gc 16 and
    gc 21, C 21, against one advanced-index gather with the rows
    precomputed;
  * bilateral_slice (K3 / K7) on a seeded grid at the cells of the main
    path's guide (B 8, 64x64, C 21), SEC prediction's on the default and
    the v1 route (B 1, 38x50, C 21) and the wide path's (B 2, 32x32,
    C 40), and on a one-run input (B 1, 8x8, C 1: its fixed cost),
    against one torch.sparse.mm (CSR) of the same function;
  * bilateral_fold (K5) on seeded partials of every shape chip_smoke.py
    and the card tests give it, an odd cube (gc 17, C 33) and one 1x1-tile
    partial (its fixed cost), against F.fold at SEC's, the wide and the
    batch-8 shape;
  * bilateral_fold_blur (K6) on seeded partials and bilateral_cube_blur
    (K8) on seeded grids of every shape chip_smoke.py and the card tests
    give them: SEC prediction's v1 grid (B 1, 5x7 tiles, gc 16; C 21,
    C 1), the wide path's (B 2, 4x4 tiles; C 40, C 1), batch 8 (8x8
    tiles; C 21, C 40), the finest cubes (gc 52 and 64, C 1), gc 16 C 64
    and gc 24 C 42, and for K8 the aligned filter's grid (B 8, 17x17,
    C 21), each held bit-equal to the tree's plain version.
--only picks some of bilateral_splat_tiles, bilateral_slice_aligned,
bilateral_fold_blur, bilateral_cube_blur, bilateral_slice and
bilateral_fold.
Each time is chip_smoke.py's: `ms` one call between CUDA events (host
work included), `device_ms` a call's share of a CUDA graph of 10 calls
back to back (the device's time).
The bound counts each byte the function must move once at 3.35 TB/s.
Prints the card's name and power limit, then one JSON line.  Needs a
card; imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_helpers():
    """chip_smoke.py of this repository (timing helpers, the paths'
    guides), loaded by its path so that another tree's copy is not."""
    spec = importlib.util.spec_from_file_location('chip_smoke_helpers',
                                                  ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_splat_tiles(torch, cs, K, mxu_grid, cell_mult):
    gen = torch.Generator(device='cuda').manual_seed(2)
    out = {}
    flag = mxu_grid._V2_DISABLED
    for path, c in (('sec', 21), ('sec', 1), ('wide', 40), ('wide', 1),
                    ('hsn', 21), ('hsn', 40)):
        guide = cs.path_guide(torch, path, gen)
        mxu_grid._V2_DISABLED = True
        try:
            geo = mxu_grid.MXUBilateralGrid(guide, 8.0, 13.0, c,
                                            cell_mult=cell_mult)
        finally:
            mxu_grid._V2_DISABLED = flag
        t, gc, cell = geo.t, geo.gc, geo.cell
        x = torch.rand(tuple(guide.shape[:3]) + (c,), generator=gen,
                       device='cuda')
        part = K.bilateral_splat_tiles(x, cell, t, gc)
        cs.check(torch.equal(part, K.bilateral_splat_tiles_plain(
            x, cell, t, gc)), f'bilateral_splat_tiles {path} C={c} is not '
            'bit-equal to its plain version')
        gc3 = gc ** 3
        gy, gx = geo.gy, geo.gx
        corner = K.corner_rows(cell, t, gy - 1, gx - 1, gc3, own_tile=True)
        rows4 = torch.cat([((r - cell) * 4 + q * gc3 + cell).reshape(-1)
                           for q, (r, _) in enumerate(corner)])
        vals4 = torch.cat([(w[..., None] * x).reshape(-1, c)
                           for _, w in corner])
        n_rows = part.numel() // c

        def lib():
            return torch.zeros((n_rows, c), device='cuda'
                               ).index_add_(0, rows4, vals4)

        def kernel():
            return K.bilateral_splat_tiles(x, cell, t, gc)
        bb, _ = cs.bound_ms(part.numel() * 4 + x.numel() * 4
                            + cell.numel() * 4, 4 * 3 * x.numel())
        key = {'hsn': 'b8'}.get(path, path) + f'_c{c}'
        out[key] = dict(ms=cs.cuda_ms(torch, kernel),
                        device_ms=cs.burst_ms(torch, kernel),
                        library_ms=cs.cuda_ms(torch, lib),
                        library_device_ms=cs.burst_ms(torch, lib),
                        fill_device_ms=cs.burst_ms(
                            torch, lambda: part.fill_(1.0)),
                        bound_ms=bb)
        del part
        del rows4, vals4, corner
        torch.cuda.empty_cache()
    return out


def time_slice_aligned(torch, cs, K, mxu_grid, cell_mult):
    gen = torch.Generator(device='cuda').manual_seed(6)
    out = {}
    for key, mult in (('b8_gc16', cell_mult), ('b8_gc21', 1.0)):
        imgs = torch.rand((cs.BATCH, cs.SIZE, cs.SIZE, 3), generator=gen,
                          device='cuda') * 255
        geo = mxu_grid.AlignedBilateralGrid(imgs, 40.0, 13.0, 21,
                                            cell_mult=mult)
        t, gc, cell = geo.t, geo.gc, geo.cell
        grid = torch.rand((cs.BATCH, geo.nty, geo.ntx, gc, gc, gc, 21),
                          generator=gen, device='cuda')
        rows = K._tile_rows(cell, t, gc ** 3)
        g_flat = grid.reshape(-1, 21)
        got = K.bilateral_slice_aligned(grid, cell, t)
        cs.check(torch.equal(got, g_flat[rows]),
                 f'bilateral_slice_aligned {key} is not bit-equal to the '
                 'gather')
        touched = int(torch.unique(rows).numel())
        bb, _ = cs.bound_ms(touched * 21 * 4 + cell.numel() * 4
                            + got.numel() * 4, 0)
        del got

        def kernel():
            return K.bilateral_slice_aligned(grid, cell, t)

        def lib():
            return g_flat[rows]
        out[key] = dict(ms=cs.cuda_ms(torch, kernel),
                        device_ms=cs.burst_ms(torch, kernel),
                        library_ms=cs.cuda_ms(torch, lib),
                        library_device_ms=cs.burst_ms(torch, lib),
                        bound_ms=bb)
        del grid, g_flat, rows
        torch.cuda.empty_cache()
    return out


# the slice (K3 / K7): (case, path, C, v1 route); the one-run input
# ('fixed': B 1, 8x8 guide, t 8, gc 16, C 1) is the kernel's fixed cost
SLICE_CASES = (('hsn_c21', 'hsn', 21, False),
               ('sec_v2_c21', 'sec', 21, False), ('sec_c21', 'sec', 21, True),
               ('wide_c40', 'wide', 40, True), ('fixed', None, 1, False))


def time_slice(torch, cs, K, mxu_grid, cell_mult):
    """bilateral_slice on a seeded grid at the cells of each path's guide,
    bit-equal to the tree's plain version, beside one torch.sparse.mm
    (CSR) of the same function."""
    gen = torch.Generator(device='cuda').manual_seed(4)
    out = {}
    flag = mxu_grid._V2_DISABLED
    for key, path, c, v1 in SLICE_CASES:
        if path is None:
            b, t, gy, gx, gc = 1, 8, 2, 2, 16
            cell = torch.randint(0, gc ** 3, (1, 8, 8), generator=gen,
                                 device='cuda', dtype=torch.int32)
        else:
            guide = cs.path_guide(torch, path, gen)
            mxu_grid._V2_DISABLED = flag or v1
            try:
                geo = mxu_grid.MXUBilateralGrid(guide, 8.0, 13.0, c,
                                                cell_mult=cell_mult)
            finally:
                mxu_grid._V2_DISABLED = flag
            cs.check(geo.v2 != v1, f'{key}: route changed')
            b, t, gy, gx, gc, cell = (guide.shape[0], geo.t, geo.gy, geo.gx,
                                      geo.gc, geo.cell)
        grid = torch.rand((b, gy, gx, gc, gc, gc, c), generator=gen,
                          device='cuda')
        got = K.bilateral_slice(grid, cell, t)
        cs.check(torch.equal(got, K.bilateral_slice_plain(grid, cell, t)),
                 f'bilateral_slice {key} is not bit-equal to its plain '
                 'version')
        lib, touched = cs.slice_library(torch, K, cell, t, gy, gx, gc, grid)
        bb, _ = cs.bound_ms(touched * c * 4 + cell.numel() * 4
                            + got.numel() * 4, 7 * got.numel())
        del got

        def kernel():
            return K.bilateral_slice(grid, cell, t)
        out[key] = dict(ms=cs.cuda_ms(torch, kernel),
                        device_ms=cs.burst_ms(torch, kernel),
                        library_ms=cs.cuda_ms(torch, lib),
                        library_device_ms=cs.burst_ms(torch, lib),
                        bound_ms=bb)
        del grid, lib
        torch.cuda.empty_cache()
    return out


# the fold (K5) on seeded partials [B, nty, ntx, 4, gc, gc, gc, C]: every
# shape chip_smoke.py and the card tests give it, an odd cube (gc 17 C 33:
# 4-byte words) and one 1x1-tile partial ('fixed': the fixed cost); F.fold
# beside it where chip_smoke.py times it
FOLD_CASES = (('sec_c21', (1, 5, 7), 16, 21), ('sec_c1', (1, 5, 7), 16, 1),
              ('wide_c40', (2, 4, 4), 16, 40), ('wide_c1', (2, 4, 4), 16, 1),
              ('b8_c21', (8, 8, 8), 16, 21), ('b8_c40', (8, 8, 8), 16, 40),
              ('gc17_c33', (1, 2, 3), 17, 33), ('gc52_c1', (1, 8, 8), 52, 1),
              ('gc64_c1', (2, 2, 3), 64, 1), ('gc16_c64', (2, 2, 3), 16, 64),
              ('gc24_c42', (2, 2, 3), 24, 42), ('fixed', (1, 1, 1), 16, 1))
FOLD_LIBRARY = ('sec_c21', 'wide_c40', 'b8_c21')


def time_fold(torch, cs, K):
    gen = torch.Generator(device='cuda').manual_seed(5)
    out = {}
    for key, (b, nty, ntx), gc, c in FOLD_CASES:
        part = torch.rand((b, nty, ntx, 4) + (gc,) * 3 + (c,),
                          generator=gen, device='cuda')
        got = K.bilateral_fold(part)
        cs.check(torch.equal(got, K.bilateral_fold_plain(part)),
                 f'bilateral_fold {key} is not bit-equal to its plain '
                 'version')
        bb, _ = cs.bound_ms(part.numel() * 4 + got.numel() * 4,
                            3 * got.numel())
        r = out[key] = dict(ms=cs.cuda_ms(torch, lambda: K.bilateral_fold(
            part)), device_ms=cs.burst_ms(torch, lambda: K.bilateral_fold(
                part)), bound_ms=bb)
        if key in FOLD_LIBRARY:
            # chip_smoke.py's yardstick: F.fold on a copy of the partials
            # laid out [B, m*4 + q, tile], the copy not timed
            m = gc ** 3 * c
            cols = part.view(b, nty * ntx, 4, m).permute(0, 3, 2, 1)
            cols = cols.reshape(b, m * 4, -1)

            def lib():
                return torch.nn.functional.fold(cols, (nty + 1, ntx + 1),
                                                kernel_size=2)
            r.update(library_ms=cs.cuda_ms(torch, lib, reps=10),
                     library_device_ms=cs.burst_ms(torch, lib, reps=3))
            del cols
        del got, part
        torch.cuda.empty_cache()
    return out


# (kernel, case, shape): K6 on partials [B, nty, ntx, 4, gc, gc, gc, C],
# K8 on a grid [B, gy, gx, gc, gc, gc, C]: every shape chip_smoke.py and
# the card tests give them
_GRIDS = (('sec_c21', (1, 5, 7), 16, 21), ('sec_c1', (1, 5, 7), 16, 1),
          ('wide_c40', (2, 4, 4), 16, 40), ('wide_c1', (2, 4, 4), 16, 1),
          ('b8_c21', (8, 8, 8), 16, 21), ('b8_c40', (8, 8, 8), 16, 40),
          ('gc52_c1', (1, 8, 8), 52, 1), ('gc64_c1', (2, 2, 3), 64, 1),
          ('gc16_c64', (2, 2, 3), 16, 64), ('gc24_c42', (2, 2, 3), 24, 42))
CUBE_CASES = tuple(
    ('bilateral_fold_blur', case, (b, ty, tx, 4) + (gc,) * 3 + (c,))
    for case, (b, ty, tx), gc, c in _GRIDS) + tuple(
    ('bilateral_cube_blur', case, (b, ty + 1, tx + 1) + (gc,) * 3 + (c,))
    for case, (b, ty, tx), gc, c in _GRIDS) + (
    ('bilateral_cube_blur', 'aligned_b8', (8, 17, 17, 16, 16, 16, 21)),)


def time_cube_blurs(torch, cs, K, mxu_grid, only):
    gen = torch.Generator(device='cuda').manual_seed(3)
    taps = mxu_grid._blur_taps(0.913)[2:]
    out = {}
    for name, case, shape in CUBE_CASES:
        if name not in only:
            continue
        x = torch.rand(shape, generator=gen, device='cuda')
        kernel, plain = getattr(K, name), getattr(K, name + '_plain')
        got = kernel(x, taps)
        cs.check(torch.equal(got, plain(x, taps)),
                 f'{name} {case} is not bit-equal to its plain version')
        bb, _ = cs.bound_ms(x.numel() * 4 + got.numel() * 4, 0)
        del got
        torch.cuda.empty_cache()
        out.setdefault(name, {})[case] = dict(
            ms=cs.cuda_ms(torch, lambda: kernel(x, taps)),
            device_ms=cs.burst_ms(torch, lambda: kernel(x, taps)),
            bound_ms=bb)
        del x
        torch.cuda.empty_cache()
    return out


KERNELS = ('bilateral_splat_tiles', 'bilateral_slice_aligned',
           'bilateral_fold_blur', 'bilateral_cube_blur', 'bilateral_slice',
           'bilateral_fold')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', default=str(ROOT),
                    help='checkout whose wsss_tpu_torch is timed')
    ap.add_argument('--only', nargs='+', choices=KERNELS, default=KERNELS,
                    help='the kernels to time (default: all)')
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    cs = load_helpers()
    smi = cs.phase_device(torch)
    from wsss_tpu_torch.kernels import bilateral as K
    from wsss_tpu_torch.kernels import build
    from wsss_tpu_torch.ops.crf import mxu_grid
    from wsss_tpu_torch.ops.crf.meanfield import MXU_CELL_MULT
    cs.check(pathlib.Path(K.__file__).resolve().is_relative_to(tree),
             f'wsss_tpu_torch came from {K.__file__}, not {tree}')
    build.build()
    res = {'tree': str(tree), 'card': smi}
    if 'bilateral_splat_tiles' in args.only:
        res['bilateral_splat_tiles'] = time_splat_tiles(
            torch, cs, K, mxu_grid, MXU_CELL_MULT)
    if 'bilateral_slice_aligned' in args.only:
        res['bilateral_slice_aligned'] = time_slice_aligned(
            torch, cs, K, mxu_grid, MXU_CELL_MULT)
    res.update(time_cube_blurs(torch, cs, K, mxu_grid, args.only))
    if 'bilateral_slice' in args.only:
        res['bilateral_slice'] = time_slice(torch, cs, K, mxu_grid,
                                            MXU_CELL_MULT)
    if 'bilateral_fold' in args.only:
        res['bilateral_fold'] = time_fold(torch, cs, K)
    for name in KERNELS:
        for key, r in res.get(name, {}).items():
            fill = (f'; fill_ {r["fill_device_ms"]:.4f}'
                    if 'fill_device_ms' in r else '')
            lib = (f'; library {r["library_ms"]:.4f} / '
                   f'{r["library_device_ms"]:.4f}'
                   if 'library_ms' in r else '')
            print(f'[time] {name} {key}: {r["ms"]:.4f} ms a call, '
                  f'{r["device_ms"]:.4f} on the device{lib}{fill}; bound '
                  f'{r["bound_ms"]:.4f} ms')
    print(json.dumps(res))


if __name__ == '__main__':
    sys.exit(main())
