"""The bilateral-grid kernels of the CRF, each with its plain PyTorch
version and a launch counter.

The grid is canonical: ``[B, gy, gx, gc, gc, gc, C]`` float32, C
innermost.  Node (ny, nx) sits at the corner of spatial tiles; a pixel
(y, x) lies in tile (y // t, x // t) and touches the 4 nodes
(y // t + by, x // t + bx), by, bx in {0, 1}, with bilinear weights
``w_0 = 1 - (y % t) / t``, ``w_1 = (y % t) / t``.  ``cell`` [B, H, W]
int32 is each pixel's nearest colour cell ``(cr * gc + cg) * gc + cb``.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the hand-written kernel of ``csrc/`` or raises.  Inside
``plain_versions()`` CUDA tensors take the plain versions too, so a run
can hold the kernels against them on the card; nothing falls back to
them on its own.

The v1 route keeps the reference's two-step splat: per-tile partials
``[B, nty, ntx, 4, gc, gc, gc, C]`` (corner q = by*2 + bx of tile
(ty, tx) belongs to node (ty + by, tx + bx)), then a fold in a fixed
order.  No sum there depends on the order of atomics, so the v1 kernels
give the same bits on every run and equal their plain versions bit for
bit.

Each wrapper launches ``csrc/<its name>.cu`` and replaces, in
wsss_tpu/ops/crf/mxu_grid.py:
  * bilateral_splat        _splat_kernel_v2 (:289) and the fold of
                           _combine_blur_kernel_v2 (:356);
  * bilateral_color_blur   the colour blur of _combine_blur_kernel_v2;
  * bilateral_slice        _slice_kernel (:448) as _slice_v2 (:1052) and
                           as _slice (:1090) call it: the canonical grid
                           is the same whichever route filled it;
  * bilateral_splat_tiles  _splat_kernel (:226);
  * bilateral_fold         _combine_kernel (:414);
  * bilateral_fold_blur    _combine_blur_kernel (:537);
  * bilateral_cube_blur    _color_blur_kernel (:515);
  * bilateral_splat_aligned  _splat_aligned_kernel (:1167);
  * bilateral_slice_aligned  _slice_aligned_kernel (:1203);
and, in wsss_tpu/ops/crf/pallas_blur.py, ``flat_color_blur`` replaces
color_blur_fused (:47) and the kernel of blur_color_axes (:84): one
kernel and one count, on whole-F stripes for the first and on per-gr
stripes plus one whole-F pass for the second.

The aligned grid ``[B, nty, ntx, gc, gc, gc, C]`` has one spatial cell
per pixel tile (no node row of its own): a pixel belongs to the cell of
tile (y // t, x // t), with no weights.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Sequence, Tuple

import torch

from wsss_tpu_torch.kernels import build as _build

# launches of each kernel, counted where the wrapper launches it (one per
# CUDA launch: bilateral_color_blur launches three, one per colour axis)
LAUNCHES: Dict[str, int] = {'bilateral_splat': 0,
                            'bilateral_color_blur': 0,
                            'bilateral_slice': 0,
                            'bilateral_splat_tiles': 0,
                            'bilateral_fold': 0,
                            'bilateral_fold_blur': 0,
                            'bilateral_cube_blur': 0,
                            'bilateral_splat_aligned': 0,
                            'bilateral_slice_aligned': 0,
                            'flat_color_blur': 0}

_FORCE_PLAIN = False

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions on CUDA tensors too (the on-card
    comparison of kernel against plain)."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def _use_kernel(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if len(devs) != 1:
        raise ValueError(f'tensors on mixed devices {sorted(devs)}')
    dev = devs.pop()
    if dev == 'cpu':
        return False
    if dev != 'cuda':
        raise ValueError(f'no bilateral kernel for device {dev!r}')
    if any(t.device.index not in (None, torch.cuda.current_device())
           for t in tensors):
        raise ValueError('tensors must be on the current CUDA device')
    return not _FORCE_PLAIN


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f'{name}: want {dtype}, got {t.dtype}')
    if t.ndim != ndim:
        raise ValueError(f'{name}: want {ndim} dims, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {rc}')


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _pixel_geometry(h: int, w: int, t: int, device):
    """Per-row / per-column tile index and the two bilinear weights."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    fy = (ys % t).to(torch.float32) / t
    fx = (xs % t).to(torch.float32) / t
    return ys // t, xs // t, (1.0 - fy, fy), (1.0 - fx, fx)


def corner_rows(cell: torch.Tensor, t: int, ny: int, nx: int, gc3: int,
                 own_tile: bool = False):
    """[(flat row [B,H,W], weight [H,W]) for the 4 corners q = by*2 + bx]
    of an array viewed as [B*ny*nx*gc3, C]: rows of node
    (y//t + by, x//t + bx) of the grid, or with own_tile of the pixel's
    tile (y//t, x//t) for every corner (the per-tile partials)."""
    b, h, w = cell.shape
    ty, tx, wy, wx = _pixel_geometry(h, w, t, cell.device)
    bi = torch.arange(b, device=cell.device).view(b, 1, 1)
    out = []
    for by in (0, 1):
        for bx in (0, 1):
            oy, ox = (0, 0) if own_tile else (by, bx)
            node = (bi * ny + (ty + oy).view(1, h, 1)) * nx \
                + (tx + ox).view(1, 1, w)
            out.append((node * gc3 + cell.long(),
                        wy[by].view(h, 1) * wx[bx].view(1, w)))
    return out


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and back: the reference's rounding points,
    reproduced by the plain versions' ref_round switch."""
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# splat
# ---------------------------------------------------------------------------

def bilateral_splat_plain(x: torch.Tensor, cell: torch.Tensor, t: int,
                          gy: int, gx: int, gc: int,
                          ref_round: bool = False) -> torch.Tensor:
    """Plain splat: ``index_add_`` over flattened grid rows.

    ref_round reproduces the JAX kernels' bf16 rounding points (the
    per-pixel weighted value and each tile's corner partial, mxu_grid.py
    :331/:347/:353) by splatting per-tile partials first and folding them
    after in f32 — only to make CPU parity tests tight."""
    b, h, w, c = x.shape
    gc3 = gc ** 3
    if not ref_round:
        grid = torch.zeros(b * gy * gx * gc3, c, dtype=torch.float32,
                           device=x.device)
        for rows, wq in corner_rows(cell, t, gy, gx, gc3):
            grid.index_add_(0, rows.reshape(-1),
                            (wq[..., None] * x).reshape(-1, c))
        return grid.view(b, gy, gx, gc, gc, gc, c)
    return bilateral_fold_plain(
        bilateral_splat_tiles_plain(x, cell, t, gc, ref_round=True))


def bilateral_splat(x: torch.Tensor, cell: torch.Tensor, t: int, gy: int,
                    gx: int, gc: int) -> torch.Tensor:
    """x [B,H,W,C] f32, cell [B,H,W] int32 -> grid [B,gy,gx,gc,gc,gc,C]."""
    if not _use_kernel(x, cell):
        return bilateral_splat_plain(x, cell, t, gy, gx, gc)
    _check(x, 'x', torch.float32, 4)
    _check(cell, 'cell', torch.int32, 3)
    b, h, w, c = x.shape
    if tuple(cell.shape) != (b, h, w):
        raise ValueError(f'cell {tuple(cell.shape)} vs x {tuple(x.shape)}')
    if gy != -(-h // t) + 1 or gx != -(-w // t) + 1:
        raise ValueError(f'grid {gy}x{gx} does not fit {h}x{w} at t={t}')
    grid = torch.zeros((b, gy, gx, gc, gc, gc, c), dtype=torch.float32,
                       device=x.device)
    fn = _build.entry('bilateral_splat',
                      (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P))
    rc = fn(x.data_ptr(), cell.data_ptr(), grid.data_ptr(), b, h, w, c, t,
            gy, gx, gc ** 3, _stream())
    LAUNCHES['bilateral_splat'] += 1
    _raise_on(rc, 'bilateral_splat')
    return grid


# ---------------------------------------------------------------------------
# colour blur
# ---------------------------------------------------------------------------

def _shift_fill(x: torch.Tensor, off: int, dim: int) -> torch.Tensor:
    """out[i] = x[i + off] along dim, zero fill."""
    n = x.shape[dim]
    out = torch.zeros_like(x)
    if abs(off) < n:
        if off > 0:
            out.narrow(dim, 0, n - off).copy_(x.narrow(dim, off, n - off))
        else:
            out.narrow(dim, -off, n + off).copy_(x.narrow(dim, 0, n + off))
    return out


def bilateral_color_blur_plain(grid: torch.Tensor, taps: Sequence[float],
                               ref_round: bool = False) -> torch.Tensor:
    """Plain radius-2 blur along cr, cg, cb (dims 3, 4, 5), zero fill;
    taps = (t0, t1, t2), t0 the centre.  ref_round rounds the blurred
    cube to bf16 as the JAX combine+blur kernel stores it (:411)."""
    x = grid
    for dim in (3, 4, 5):
        acc = taps[0] * x
        for d in (1, 2):
            acc = acc + taps[d] * (_shift_fill(x, d, dim)
                                   + _shift_fill(x, -d, dim))
        x = acc
    return bf16_round(x) if ref_round else x


def _check_grid(grid: torch.Tensor):
    _check(grid, 'grid', torch.float32, 7)
    gc, c = grid.shape[3], grid.shape[6]
    if grid.shape[4] != gc or grid.shape[5] != gc:
        raise ValueError(f'grid colour axes {tuple(grid.shape[3:6])}')
    return gc, c


def bilateral_color_blur(grid: torch.Tensor, taps: Sequence[float]
                         ) -> torch.Tensor:
    """grid [B,gy,gx,gc,gc,gc,C] f32 -> the same shape, blurred along the
    three colour axes (three launches, one per axis)."""
    if not _use_kernel(grid):
        return bilateral_color_blur_plain(grid, taps)
    gc, c = _check_grid(grid)
    t0, t1, t2 = (float(v) for v in taps)
    fn = _build.entry('bilateral_color_blur',
                      (_P, _P, _LL, _LL, _I, _F, _F, _F, _P))
    a = torch.empty_like(grid)
    bufs = (grid, a, torch.empty_like(grid), a)
    n = grid.numel()
    for k, stride in enumerate((gc * gc * c, gc * c, c)):     # cr, cg, cb
        rc = fn(bufs[k].data_ptr(), bufs[k + 1].data_ptr(), n, stride, gc,
                t0, t1, t2, _stream())
        LAUNCHES['bilateral_color_blur'] += 1
        _raise_on(rc, 'bilateral_color_blur')
    return bufs[3]


# ---------------------------------------------------------------------------
# slice
# ---------------------------------------------------------------------------

def bilateral_slice_plain(grid: torch.Tensor, cell: torch.Tensor, t: int
                          ) -> torch.Tensor:
    """Plain slice: ``gather`` of the 4 corner rows at the pixel's cell,
    weighted and summed in corner order."""
    b, gy, gx, gc = grid.shape[:4]
    c = grid.shape[6]
    flat = grid.reshape(-1, c)
    out = 0
    for rows, wq in corner_rows(cell, t, gy, gx, gc ** 3):
        idx = rows.reshape(-1, 1).expand(-1, c)
        out = out + wq[..., None] * flat.gather(0, idx).view(
            cell.shape + (c,))
    return out


def bilateral_slice(grid: torch.Tensor, cell: torch.Tensor, t: int
                    ) -> torch.Tensor:
    """grid [B,gy,gx,gc,gc,gc,C] f32, cell [B,H,W] int32 -> [B,H,W,C]."""
    if not _use_kernel(grid, cell):
        return bilateral_slice_plain(grid, cell, t)
    _check(grid, 'grid', torch.float32, 7)
    _check(cell, 'cell', torch.int32, 3)
    b, gy, gx, gc = grid.shape[:4]
    c = grid.shape[6]
    h, w = cell.shape[1:]
    if cell.shape[0] != b or gy != -(-h // t) + 1 or gx != -(-w // t) + 1:
        raise ValueError(f'cell {tuple(cell.shape)} does not fit grid '
                         f'{tuple(grid.shape)} at t={t}')
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=grid.device)
    fn = _build.entry('bilateral_slice',
                      (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P))
    rc = fn(grid.data_ptr(), cell.data_ptr(), out.data_ptr(), b, h, w, c, t,
            gy, gx, gc ** 3, _stream())
    LAUNCHES['bilateral_slice'] += 1
    _raise_on(rc, 'bilateral_slice')
    return out


# ---------------------------------------------------------------------------
# v1 route: per-tile partials, fold, fused colour-cube blur
# ---------------------------------------------------------------------------

def bilateral_splat_tiles_plain(x: torch.Tensor, cell: torch.Tensor, t: int,
                                gc: int, ref_round: bool = False
                                ) -> torch.Tensor:
    """Plain per-tile splat: partials [B, nty, ntx, 4, gc, gc, gc, C] with
    ``P[b,ty,tx,q,m] = sum over the tile's pixels of w_q(p) 1[cell(p)=m]
    x[p]``, the pixels of a tile added in row-major order.

    One step per in-tile position (iy, ix): that position's pixel of
    every tile is added to its own row at once.  The rows of a step are
    distinct (one pixel per tile and corner), so the step is a gather,
    an add and a scatter with no atomics, and the result has the same
    bits on every device and run.

    ref_round rounds each weighted value and each finished partial to
    bf16 (mxu_grid.py :262 and :286)."""
    b, h, w, c = x.shape
    nty, ntx = -(-h // t), -(-w // t)
    gc3 = gc ** 3
    dev = x.device
    part = torch.zeros(b * nty * ntx * 4 * gc3, c, dtype=torch.float32,
                       device=dev)
    _, _, wy, wx = _pixel_geometry(h, w, t, dev)
    wy, wx = torch.stack(wy), torch.stack(wx)             # [2,H], [2,W]
    tile = ((torch.arange(b, device=dev).view(b, 1, 1) * nty
             + torch.arange(nty, device=dev).view(1, nty, 1)) * ntx
            + torch.arange(ntx, device=dev).view(1, 1, ntx))
    q = torch.arange(4, device=dev).view(4, 1, 1, 1)
    for iy in range(min(t, h)):
        for ix in range(min(t, w)):
            xs = x[:, iy::t, ix::t]                       # one pixel a tile
            ny, nx = xs.shape[1:3]
            rows = ((tile[None, :, :ny, :nx] * 4 + q) * gc3
                    + cell[None, :, iy::t, ix::t].long()).reshape(-1)
            w4 = (wy[:, iy].view(2, 1) * wx[:, ix].view(1, 2)).reshape(4)
            val = w4.view(4, 1, 1, 1, 1) * xs[None]
            if ref_round:
                val = bf16_round(val)
            part[rows] = part[rows] + val.reshape(-1, c)
    if ref_round:
        part = bf16_round(part)
    return part.view(b, nty, ntx, 4, gc, gc, gc, c)


def bilateral_splat_tiles(x: torch.Tensor, cell: torch.Tensor, t: int,
                          gc: int) -> torch.Tensor:
    """x [B,H,W,C] f32, cell [B,H,W] int32 -> per-tile partials
    [B,nty,ntx,4,gc,gc,gc,C] (one launch; bit-equal to the plain
    version)."""
    if not _use_kernel(x, cell):
        return bilateral_splat_tiles_plain(x, cell, t, gc)
    _check(x, 'x', torch.float32, 4)
    _check(cell, 'cell', torch.int32, 3)
    b, h, w, c = x.shape
    if tuple(cell.shape) != (b, h, w):
        raise ValueError(f'cell {tuple(cell.shape)} vs x {tuple(x.shape)}')
    nty, ntx = -(-h // t), -(-w // t)
    part = torch.zeros((b, nty, ntx, 4, gc, gc, gc, c), dtype=torch.float32,
                       device=x.device)
    fn = _build.entry('bilateral_splat_tiles',
                      (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P))
    rc = fn(x.data_ptr(), cell.data_ptr(), part.data_ptr(), b, h, w, c, t,
            nty, ntx, gc ** 3, _stream())
    LAUNCHES['bilateral_splat_tiles'] += 1
    _raise_on(rc, 'bilateral_splat_tiles')
    return part


# tile (sy-1+dy, sx-1+dx) gives node (sy, sx) its corner q = (1-dy)*2 +
# (1-dx); the reference adds them in this order (mxu_grid.py :434-438)
_FOLD_ORDER = ((3, 0, 0), (2, 0, 1), (1, 1, 0), (0, 1, 1))   # (q, dy, dx)


def _check_partials(part: torch.Tensor):
    _check(part, 'partials', torch.float32, 8)
    b, nty, ntx, nq, gc = part.shape[:5]
    if nq != 4 or part.shape[5] != gc or part.shape[6] != gc:
        raise ValueError(f'partials {tuple(part.shape)}: want '
                         '[B,nty,ntx,4,gc,gc,gc,C]')
    return b, nty, ntx, gc, part.shape[7]


def bilateral_fold_plain(part: torch.Tensor, ref_round: bool = False
                         ) -> torch.Tensor:
    """Plain fold of per-tile partials into the grid
    [B, nty+1, ntx+1, gc, gc, gc, C]: four shifted adds in the
    reference's order.  ref_round rounds the grid to bf16 (:445)."""
    b, nty, ntx = part.shape[:3]
    grid = torch.zeros((b, nty + 1, ntx + 1) + tuple(part.shape[4:]),
                       dtype=torch.float32, device=part.device)
    for q, dy, dx in _FOLD_ORDER:
        grid[:, 1 - dy:1 - dy + nty, 1 - dx:1 - dx + ntx] += part[:, :, :, q]
    return bf16_round(grid) if ref_round else grid


def bilateral_fold(part: torch.Tensor) -> torch.Tensor:
    """partials [B,nty,ntx,4,gc,gc,gc,C] f32 -> grid
    [B,nty+1,ntx+1,gc,gc,gc,C], no blur (bit-equal to the plain
    version)."""
    if not _use_kernel(part):
        return bilateral_fold_plain(part)
    b, nty, ntx, gc, c = _check_partials(part)
    grid = torch.empty((b, nty + 1, ntx + 1, gc, gc, gc, c),
                       dtype=torch.float32, device=part.device)
    fn = _build.entry('bilateral_fold', (_P, _P, _LL, _I, _I, _LL, _P))
    rc = fn(part.data_ptr(), grid.data_ptr(), grid.numel(), nty + 1,
            ntx + 1, gc ** 3 * c, _stream())
    LAUNCHES['bilateral_fold'] += 1
    _raise_on(rc, 'bilateral_fold')
    return grid


# shared memory of one block of the cube-blur kernels: a block may use
# 227 KB; the budget keeps three blocks on an SM where the cube allows it
_SMEM_MAX = 227 * 1024
_SMEM_BUDGET = 74 * 1024


def cube_tiling(gc: int, c: int):
    """(nc, planes): how a block of the cube-blur kernels cuts a node's
    [gc, gc, gc, C] cube.  It holds nc channels of `planes` cr-planes
    plus a 2-plane halo on each side, and a second buffer of `planes`
    planes: nc * (2 * planes + 4) * gc^2 floats.  Whole cubes (planes =
    gc, no halo re-read) of as many channels as the budget holds; a cube
    too large for one channel (gc 52: 562 KB) is cut along cr."""
    plane = gc * gc * 4
    nc = min(c, _SMEM_BUDGET // ((2 * gc + 4) * plane))
    if nc >= 1:
        return nc, gc
    planes = min(gc, (_SMEM_MAX // plane - 4) // 2)
    if planes < 1:
        raise ValueError(f'colour cube with gc={gc} does not fit a block')
    return 1, planes


def bilateral_fold_blur_plain(part: torch.Tensor, taps: Sequence[float],
                              ref_round: bool = False) -> torch.Tensor:
    """Plain fold then colour blur; ref_round keeps the folded cube in
    f32 and rounds the blurred one to bf16 (:592)."""
    return bilateral_color_blur_plain(bilateral_fold_plain(part), taps,
                                      ref_round=ref_round)


def bilateral_fold_blur(part: torch.Tensor, taps: Sequence[float]
                        ) -> torch.Tensor:
    """partials [B,nty,ntx,4,gc,gc,gc,C] f32 -> folded grid blurred along
    cr, cg, cb, in one launch (bit-equal to the plain version)."""
    if not _use_kernel(part):
        return bilateral_fold_blur_plain(part, taps)
    b, nty, ntx, gc, c = _check_partials(part)
    nc, planes = cube_tiling(gc, c)
    t0, t1, t2 = (float(v) for v in taps)
    grid = torch.empty((b, nty + 1, ntx + 1, gc, gc, gc, c),
                       dtype=torch.float32, device=part.device)
    fn = _build.entry('bilateral_fold_blur',
                      (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P))
    rc = fn(part.data_ptr(), grid.data_ptr(), b, nty + 1, ntx + 1, gc, c,
            nc, planes, t0, t1, t2, _stream())
    LAUNCHES['bilateral_fold_blur'] += 1
    _raise_on(rc, 'bilateral_fold_blur')
    return grid


def bilateral_cube_blur_plain(grid: torch.Tensor, taps: Sequence[float],
                              ref_round: bool = False) -> torch.Tensor:
    """Plain version of the one-pass cube blur: the function, arithmetic
    and order of ``bilateral_color_blur_plain`` (cr, then cg, then cb);
    ref_round rounds the result to bf16 (:534)."""
    return bilateral_color_blur_plain(grid, taps, ref_round=ref_round)


def bilateral_cube_blur(grid: torch.Tensor, taps: Sequence[float]
                        ) -> torch.Tensor:
    """grid [B,gy,gx,gc,gc,gc,C] f32 -> the same shape, blurred along the
    three colour axes in one launch: the grid is read once and written
    once (bit-equal to the plain version)."""
    if not _use_kernel(grid):
        return bilateral_cube_blur_plain(grid, taps)
    gc, c = _check_grid(grid)
    nc, planes = cube_tiling(gc, c)
    t0, t1, t2 = (float(v) for v in taps)
    out = torch.empty_like(grid)
    fn = _build.entry('bilateral_cube_blur',
                      (_P, _P, _LL, _I, _I, _I, _I, _F, _F, _F, _P))
    rc = fn(grid.data_ptr(), out.data_ptr(),
            grid.shape[0] * grid.shape[1] * grid.shape[2], gc, c, nc,
            planes, t0, t1, t2, _stream())
    LAUNCHES['bilateral_cube_blur'] += 1
    _raise_on(rc, 'bilateral_cube_blur')
    return out


# ---------------------------------------------------------------------------
# aligned grid: nearest splat and slice on the pixel tiles' own cells
# ---------------------------------------------------------------------------

def _tile_rows(cell: torch.Tensor, t: int, gc3: int) -> torch.Tensor:
    """[B,H,W] flat row of each pixel in an aligned grid viewed as
    [B*nty*ntx*gc3, C]: its own tile's colour cell."""
    h, w = cell.shape[1:]
    return corner_rows(cell, t, -(-h // t), -(-w // t), gc3,
                       own_tile=True)[0][0]


def bilateral_splat_aligned_plain(x: torch.Tensor, cell: torch.Tensor,
                                  t: int, gc: int, ref_round: bool = False
                                  ) -> torch.Tensor:
    """Plain aligned splat: one ``index_add_`` of every pixel into the
    colour cell of its own tile.  ref_round rounds the values and the
    finished grid to bf16 (mxu_grid.py :1197 and :1200; the sums between
    are f32)."""
    b, h, w, c = x.shape
    nty, ntx = -(-h // t), -(-w // t)
    if ref_round:
        x = bf16_round(x)
    grid = torch.zeros(b * nty * ntx * gc ** 3, c, dtype=torch.float32,
                       device=x.device)
    grid.index_add_(0, _tile_rows(cell, t, gc ** 3).reshape(-1),
                    x.reshape(-1, c))
    grid = grid.view(b, nty, ntx, gc, gc, gc, c)
    return bf16_round(grid) if ref_round else grid


def _check_aligned(x: torch.Tensor, cell: torch.Tensor) -> None:
    _check(x, 'x', torch.float32, 4)
    _check(cell, 'cell', torch.int32, 3)
    if tuple(cell.shape) != tuple(x.shape[:3]):
        raise ValueError(f'cell {tuple(cell.shape)} vs x {tuple(x.shape)}')


def bilateral_splat_aligned(x: torch.Tensor, cell: torch.Tensor, t: int,
                            gc: int) -> torch.Tensor:
    """x [B,H,W,C] f32, cell [B,H,W] int32 -> aligned grid
    [B,nty,ntx,gc,gc,gc,C] (one launch; atomics, so equal to the plain
    version to f32 rounding)."""
    if not _use_kernel(x, cell):
        return bilateral_splat_aligned_plain(x, cell, t, gc)
    _check_aligned(x, cell)
    b, h, w, c = x.shape
    nty, ntx = -(-h // t), -(-w // t)
    grid = torch.zeros((b, nty, ntx, gc, gc, gc, c), dtype=torch.float32,
                       device=x.device)
    fn = _build.entry('bilateral_splat_aligned',
                      (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P))
    rc = fn(x.data_ptr(), cell.data_ptr(), grid.data_ptr(), b, h, w, c, t,
            nty, ntx, gc ** 3, _stream())
    LAUNCHES['bilateral_splat_aligned'] += 1
    _raise_on(rc, 'bilateral_splat_aligned')
    return grid


def bilateral_slice_aligned_plain(grid: torch.Tensor, cell: torch.Tensor,
                                  t: int) -> torch.Tensor:
    """Plain aligned slice: an advanced-index gather of each pixel's row."""
    c = grid.shape[6]
    rows = _tile_rows(cell, t, grid.shape[3] ** 3)
    return grid.reshape(-1, c)[rows]


def bilateral_slice_aligned(grid: torch.Tensor, cell: torch.Tensor, t: int
                            ) -> torch.Tensor:
    """aligned grid [B,nty,ntx,gc,gc,gc,C] f32, cell [B,H,W] int32 ->
    [B,H,W,C] (one launch; bit-equal to the plain version)."""
    if not _use_kernel(grid, cell):
        return bilateral_slice_aligned_plain(grid, cell, t)
    gc, c = _check_grid(grid)
    _check(cell, 'cell', torch.int32, 3)
    b, nty, ntx = grid.shape[:3]
    h, w = cell.shape[1:]
    if cell.shape[0] != b or nty != -(-h // t) or ntx != -(-w // t):
        raise ValueError(f'cell {tuple(cell.shape)} does not fit aligned '
                         f'grid {tuple(grid.shape)} at t={t}')
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=grid.device)
    fn = _build.entry('bilateral_slice_aligned',
                      (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P))
    rc = fn(grid.data_ptr(), cell.data_ptr(), out.data_ptr(), b, h, w, c, t,
            nty, ntx, gc ** 3, _stream())
    LAUNCHES['bilateral_slice_aligned'] += 1
    _raise_on(rc, 'bilateral_slice_aligned')
    return out


# ---------------------------------------------------------------------------
# scatter grid: flat colour-axis blur
# ---------------------------------------------------------------------------

_FLAT_BLUR_MAX_TAPS = 17

Pass = Tuple[Sequence[float], int]      # (taps, element stride)


def flat_color_blur_plain(x: torch.Tensor, passes: Sequence[Pass]
                          ) -> torch.Tensor:
    """Plain chain of flat convolutions along the last dim of x [..., L]:
    per pass ``out[f] = sum_j taps[j] * x[f + (j - r) * stride]``, zero
    outside [0, L), the taps added in order j = 0, 1, ... (the
    reference's ``_flat_conv_last``, meanfield.py:124).  A colour axis
    embedded in the flat dim has no zero fill of its own: a shift bleeds
    into the next row, which the scatter grid's margin cells absorb."""
    n = x.shape[-1]
    for taps, stride in passes:
        r = (len(taps) - 1) // 2
        padded = torch.nn.functional.pad(x, (r * stride, r * stride))
        out = float(taps[0]) * padded[..., 0:n]
        for j in range(1, 2 * r + 1):
            out = out + float(taps[j]) * padded[..., j * stride:
                                                j * stride + n]
        x = out
    return x


def flat_color_blur(x: torch.Tensor, passes: Sequence[Pass]
                    ) -> torch.Tensor:
    """x [n_stripes, L] f32 -> the same shape after the passes, one launch
    per pass between two scratch buffers (bit-equal to the plain
    version)."""
    if not _use_kernel(x):
        return flat_color_blur_plain(x, passes)
    _check(x, 'x', torch.float32, 2)
    for taps, stride in passes:
        if not 1 <= len(taps) <= _FLAT_BLUR_MAX_TAPS or len(taps) % 2 == 0:
            raise ValueError(f'flat_color_blur takes an odd number of taps '
                             f'up to {_FLAT_BLUR_MAX_TAPS}, got {len(taps)}')
        if stride < 1:
            raise ValueError(f'stride {stride} < 1')
    fn = _build.entry('flat_color_blur',
                      (_P, _P, _LL, _LL, _LL, ctypes.POINTER(_F), _I, _P))
    n_stripes, length = x.shape
    bufs = [torch.empty_like(x) for _ in range(min(2, len(passes)))]
    src = x
    for k, (taps, stride) in enumerate(passes):
        dst = bufs[k % 2]
        ctaps = (_F * len(taps))(*(float(v) for v in taps))
        rc = fn(src.data_ptr(), dst.data_ptr(), n_stripes, length,
                int(stride), ctaps, len(taps), _stream())
        LAUNCHES['flat_color_blur'] += 1
        _raise_on(rc, 'flat_color_blur')
        src = dst
    return src
