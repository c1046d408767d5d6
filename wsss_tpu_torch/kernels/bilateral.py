"""The bilateral-grid kernels of the CRF and its direct window, each with
its plain PyTorch version and a launch counter.

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
stripes plus one whole-F pass for the second.  ``direct_window`` (the
CRF's exact window, ``meanfield.DirectBilateral``, whose plain version
is ``DirectBilateral._filter``) replaces no TPU kernel: the reference's
window is plain jnp.

The aligned grid ``[B, nty, ntx, gc, gc, gc, C]`` has one spatial cell
per pixel tile (no node row of its own): a pixel belongs to the cell of
tile (y // t, x // t), with no weights.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch

from wsss_tpu_torch.kernels import build as _build

# launches of each kernel, counted where the wrapper launches it (one per
# CUDA launch; every wrapper launches its kernel once a call)
LAUNCHES: Dict[str, int] = {'bilateral_splat': 0,
                            'bilateral_color_blur': 0,
                            'bilateral_slice': 0,
                            'bilateral_splat_tiles': 0,
                            'bilateral_fold': 0,
                            'bilateral_fold_blur': 0,
                            'bilateral_cube_blur': 0,
                            'bilateral_splat_aligned': 0,
                            'bilateral_slice_aligned': 0,
                            'flat_color_blur': 0,
                            'direct_window': 0}

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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(units: int, blocks_per_sm: int, device: torch.device) -> int:
    """Persistent blocks of a launch: as many as the card holds at once,
    at most one a unit."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return max(1, min(units, _sm_count(index) * blocks_per_sm))


def _even_blocks(units: int, blocks_per_sm: int, device: torch.device
                 ) -> int:
    """Persistent blocks of a launch that walk consecutive shares of
    `units`: as few as give each the same number of units as the most
    the card holds at once would."""
    per = -(-units // _blocks(units, blocks_per_sm, device))
    return -(-units // per)


# an H100's SMs, for the planners' cost models
_SMS = 132


def _pixel_geometry(h: int, w: int, t: int, device):
    """Per-row / per-column tile index and the two bilinear weights."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    fy = (ys % t).to(torch.float32) / t
    fx = (xs % t).to(torch.float32) / t
    return ys // t, xs // t, (1.0 - fy, fy), (1.0 - fx, fx)


@functools.lru_cache(maxsize=None)
def _tile_weights(t: int, device: torch.device) -> torch.Tensor:
    """[2, t] f32: the bilinear weights 1 - i/t and i/t of an in-tile
    offset i, computed by the ops the plain versions use.  (On the card
    PyTorch divides by a number as a multiply by its reciprocal, so a
    kernel takes this table rather than dividing by t itself.)"""
    _, _, wy, _ = _pixel_geometry(t, 1, t, device)
    return torch.stack(wy).contiguous()


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
                      (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P))
    rc = fn(x.data_ptr(), cell.data_ptr(),
            _tile_weights(t, x.device).data_ptr(), grid.data_ptr(), b, h, w,
            c, t, gy, gx, gc ** 3, _stream())
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


# Shared memory on the H100: what one block may use (dynamic and static
# together), and an SM's whole, of which each resident block costs 1 KB
# more than it asks for.
SMEM_BLOCK = 232448
_SMEM_SM = 233472


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _pow2(n: int) -> int:
    """The least power of two >= n."""
    return 1 << max(0, n - 1).bit_length()


def _blocks_per_sm(smem_bytes: int, threads: int) -> int:
    return max(1, min(_SMEM_SM // (smem_bytes + 1024), 2048 // threads, 32))


# the fewest channels of a group when a plane of all C does not fit:
# 8 floats are one 32-byte sector
_MIN_GROUP = 8


@dataclasses.dataclass(frozen=True)
class ColorBlurPlan:
    """How ``bilateral_color_blur`` cuts a [.., gc, gc, gc, C] grid.

    A block streams cr-planes of `nc` channels (all C: one contiguous span
    a plane; fewer: gc^2 runs of nc channels) through a ring of
    5 + in_flight slots of `slot` floats, and blurs each output plane in
    the work plane A ([gc + 4][gc][nc] from float `buf_a` on, 3 floats of
    room to align it; two zero cg rows at each end)."""
    gc: int
    c: int
    nc: int
    in_flight: int
    slot: int
    buf_a: int
    smem_bytes: int
    threads: int
    blocks_per_sm: int

    @property
    def groups(self) -> int:
        return -(-self.c // self.nc)

    @property
    def ring(self) -> int:
        return 5 + self.in_flight

    def channel_groups(self) -> List[Tuple[int, int]]:
        """(first channel, channels) of each group, in block order."""
        return [(c0, min(self.nc, self.c - c0))
                for c0 in range(0, self.c, self.nc)]


# the largest gc the kernel takes (a register a cb cell): the v2 route's
_COLOR_BLUR_MAX_GC = 24


@functools.lru_cache(maxsize=None)
def color_blur_plan(gc: int, c: int) -> ColorBlurPlan:
    """The geometry of ``bilateral_color_blur`` for gc colour cells an
    axis and C channels: whole planes of all C where their ring fits a
    block, else the fewest groups of >= 8 consecutive channels that fit;
    then as many planes in flight (3, 2, 1) as fit.  ValueError for gc
    over 24 or when no group of 8 channels fits."""
    if not 1 <= gc <= _COLOR_BLUR_MAX_GC or c < 1:
        raise ValueError(f'bilateral_color_blur takes gc in 1..'
                         f'{_COLOR_BLUR_MAX_GC} (the v2 route\'s) and C >= 1, '
                         f'got gc={gc}, C={c}')

    def fit(nc):
        plane = gc * gc * nc
        # a whole plane lands at a 0-3 float offset in its slot
        slot = _round4(plane + 3) if nc == c else _round4(plane)
        work = (gc + 4) * gc * nc + 3
        for f in (3, 2, 1):
            buf_a = (5 + f) * slot
            smem = 4 * (buf_a + work)
            if smem <= SMEM_BLOCK:
                # one thread a (cg, channel) row, and at most 8 cells each
                # in the cr pass
                threads = min(512, max(64, _pow2(max(gc * nc, plane // 8))))
                return ColorBlurPlan(gc, c, nc, f, slot, buf_a, smem, threads,
                                     _blocks_per_sm(smem, threads))
        return None

    for nc in range(c, min(c, _MIN_GROUP) - 1, -1):
        if fit(nc) is None:
            continue
        # the same number of groups, as even as >= 8 channels allow
        even = -(-c // -(-c // nc))
        return fit(even if even >= min(c, _MIN_GROUP) else nc)
    raise ValueError(f'bilateral_color_blur: no plan fits a block of '
                     f'{SMEM_BLOCK} bytes for gc={gc}, C={c}: even '
                     f'{min(c, _MIN_GROUP)} channels a group do not')


def bilateral_color_blur(grid: torch.Tensor, taps: Sequence[float]
                         ) -> torch.Tensor:
    """grid [B,gy,gx,gc,gc,gc,C] f32 -> the same shape, blurred along the
    three colour axes in one launch that reads the grid once and writes
    it once (bit-equal to the plain version)."""
    if not _use_kernel(grid):
        return bilateral_color_blur_plain(grid, taps)
    gc, c = _check_grid(grid)
    plan = color_blur_plan(gc, c)
    t0, t1, t2 = (float(v) for v in taps)
    out = torch.empty_like(grid)
    nodes = grid.shape[0] * grid.shape[1] * grid.shape[2]
    fn = _build.entry('bilateral_color_blur',
                      (_P, _P, _LL) + (_I,) * 10 + (_F, _F, _F, _P))
    rc = fn(grid.data_ptr(), out.data_ptr(), nodes, gc, c, plan.nc,
            plan.groups, plan.in_flight, plan.slot, plan.buf_a,
            plan.smem_bytes,
            _blocks(nodes * plan.groups, plan.blocks_per_sm, grid.device),
            plan.threads, t0, t1, t2, _stream())
    LAUNCHES['bilateral_color_blur'] += 1
    _raise_on(rc, 'bilateral_color_blur')
    return out


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


# the slice indexes pixels, grid rows and elements in 32 bits; its widest
# C, as far as the tests hold its divisions (the routes give C <= 512)
_SLICE_MAX_C = 8192
# its persistent blocks: 256 threads at most 64 registers, 1024 threads an
# SM; a thread an element up to as many elements as 132 SMs hold threads,
# else a warp a run of pixels, 8 elements a lane a round
_SLICE_THREADS = 256
_SLICE_BLOCKS_PER_SM = 1024 // _SLICE_THREADS
_SLICE_ELEMENT_MAX = _SMS * 1024
_SLICE_ROUND = 32 * 8


def slice_run(c: int, pixels: int) -> int:
    """How ``bilateral_slice`` cuts `pixels` pixels of C channels: 0 for a
    thread an element, where there are no more elements than the card
    holds threads at once (the shortest chain of dependent work a thread);
    else the pixels of a warp's run, as many as one round of 8 elements a
    lane covers (L*C <= 256), at most 32 and at least 1, so that each
    pixel's coordinates serve C elements.  ValueError past the kernel's
    C."""
    if not 1 <= c <= _SLICE_MAX_C or pixels < 1:
        raise ValueError(f'bilateral_slice takes C in 1..{_SLICE_MAX_C} and '
                         f'pixels >= 1, got C={c}, pixels={pixels}')
    if pixels * c <= _SLICE_ELEMENT_MAX:
        return 0
    return max(1, min(32, _SLICE_ROUND // c))


def bilateral_slice(grid: torch.Tensor, cell: torch.Tensor, t: int
                    ) -> torch.Tensor:
    """grid [B,gy,gx,gc,gc,gc,C] f32, cell [B,H,W] int32 -> [B,H,W,C] (one
    launch, a thread an element or a warp a run of flat pixels as
    ``slice_run`` cuts them; bit-equal to the plain version)."""
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
    if (cell.numel() >= 2 ** 31 or grid.numel() // max(c, 1) >= 2 ** 31
            or c > _SLICE_MAX_C):
        raise ValueError(f'bilateral_slice takes under 2^31 pixels and grid '
                         f'rows and C <= {_SLICE_MAX_C}, got grid '
                         f'{tuple(grid.shape)}, cell {tuple(cell.shape)}')
    run = slice_run(c, cell.numel())
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=grid.device)
    # threads for the elements, or warps for the runs
    units = (cell.numel() * c if run == 0
             else -(-cell.numel() // run) * 32)
    blocks = _blocks(-(-units // _SLICE_THREADS), _SLICE_BLOCKS_PER_SM,
                     grid.device)
    fn = _build.entry('bilateral_slice',
                      (_P, _P, _P, _P) + (_I,) * 10 + (_P,))
    rc = fn(grid.data_ptr(), cell.data_ptr(),
            _tile_weights(t, grid.device).data_ptr(), out.data_ptr(), b, h,
            w, c, t, gy, gx, gc ** 3, run, blocks, _stream())
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


# the tile splat's blocks: 256 threads, and shared memory for 4 of them
# on an SM unless a large tile's staging needs more
_SPLAT_TILES_THREADS = 256
_SPLAT_TILES_SMEM = _SMEM_SM // 4 - 1024 - 4 * 32
# a tile's pixel values are staged whole up to this many bytes, else
# `chunk` pixels of a range at a time
_SPLAT_TILES_STAGE = 16384
# the kernel packs a pixel's place in its tile into 6 + 6 bits and its
# cell in the range into the 19 above them
_SPLAT_TILES_MAX_T = 64
_SPLAT_TILES_MAX_CELLS = 1 << 19
# ranges of at most 1/8 of a slab, so that a narrow slab (C 1) still
# spreads over blocks
_SPLAT_TILES_MIN_RANGES = 8


@dataclasses.dataclass(frozen=True)
class SplatTilesPlan:
    """How ``bilateral_splat_tiles`` cuts a tile's partials
    [4, gc^3, C].

    A unit of work is a tile and a range of `cells` consecutive colour
    cells (`ranges` of them a slab, the last ragged; ``cut()``); a block
    builds all four corners of a unit in shared memory, one segment of
    `seg` floats a corner, the range at a 0-3 float offset that matches
    the alignment of its run in device memory.  Behind the four
    segments: the bilinear weights [2][t] (rounded up to 4 floats), the
    tile's cells [t*t], the codes of the pixels in the range [t*t] and
    pixel values: the whole tile's [t*t][C] (`chunk` 0) or `chunk` of the
    range's pixels at a time [chunk][C]."""
    gc: int
    c: int
    t: int
    cells: int
    ranges: int
    chunk: int
    seg: int
    smem_bytes: int
    threads: int
    blocks_per_sm: int

    def cut(self) -> List[Tuple[int, int]]:
        """(first cell, cells) of each range, in order."""
        gc3 = self.gc ** 3
        return [(m0, min(self.cells, gc3 - m0))
                for m0 in range(0, gc3, self.cells)]


def _splat_tiles_fixed(c: int, t: int, chunk: int) -> int:
    """Bytes of a block's shared memory besides the four segments."""
    return 4 * (_round4(2 * t) + 2 * t * t + (chunk or t * t) * c)


@functools.lru_cache(maxsize=None)
def splat_tiles_plan(gc: int, c: int, t: int) -> SplatTilesPlan:
    """The geometry of ``bilateral_splat_tiles`` for gc colour cells an
    axis, C channels and t x t pixel tiles: the tile's values staged
    whole where they take at most 16 KB; ranges as long as four corners
    of them fit the block's share of shared memory (a quarter of an SM's,
    or twice what the staging takes where that is more) and no longer
    than 1/8 of the slab, cut as evenly as that number of ranges allows
    in whole 128-byte lines of a corner's run where the range has room
    for one.  ValueError where not even one cell of four corners fits, or
    t is over 64."""
    if gc < 1 or c < 1 or not 1 <= t <= _SPLAT_TILES_MAX_T:
        raise ValueError(f'bilateral_splat_tiles takes gc >= 1, C >= 1 and '
                         f't in 1..{_SPLAT_TILES_MAX_T}, got gc={gc}, '
                         f'C={c}, t={t}')
    gc3 = gc ** 3
    chunk = (0 if 4 * t * t * c <= _SPLAT_TILES_STAGE
             else min(t * t, max(8, min(64, 4096 // c))))
    fixed = _splat_tiles_fixed(c, t, chunk)
    budget = min(SMEM_BLOCK - 4 * 32, max(_SPLAT_TILES_SMEM, 2 * fixed))
    seg_max = (budget - fixed) // 16 // 4 * 4         # floats a corner
    most = min((seg_max - 3) // c, -(-gc3 // _SPLAT_TILES_MIN_RANGES),
               _SPLAT_TILES_MAX_CELLS)
    if most < 1:
        raise ValueError(f'bilateral_splat_tiles: no plan fits a block of '
                         f'{SMEM_BLOCK} bytes for gc={gc}, C={c}, t={t}: '
                         f'not even one cell of four corners')
    # the fewest cells whose run is whole 128-byte lines
    line = 32 // math.gcd(c, 32)
    if most >= line:
        most = most // line * line
    else:
        line = 1
    ranges = -(-gc3 // most)
    even = -(-gc3 // ranges)
    cells = -(-even // line) * line
    ranges = -(-gc3 // cells)
    seg = _round4(cells * c + 3)
    smem = fixed + 16 * seg
    return SplatTilesPlan(gc, c, t, cells, ranges, chunk, seg, smem,
                          _SPLAT_TILES_THREADS,
                          _blocks_per_sm(smem + 4 * 32,
                                         _SPLAT_TILES_THREADS))


def bilateral_splat_tiles(x: torch.Tensor, cell: torch.Tensor, t: int,
                          gc: int) -> torch.Tensor:
    """x [B,H,W,C] f32, cell [B,H,W] int32 -> per-tile partials
    [B,nty,ntx,4,gc,gc,gc,C] (one launch that writes every element once,
    no memset; bit-equal to the plain version)."""
    if not _use_kernel(x, cell):
        return bilateral_splat_tiles_plain(x, cell, t, gc)
    _check(x, 'x', torch.float32, 4)
    _check(cell, 'cell', torch.int32, 3)
    b, h, w, c = x.shape
    if tuple(cell.shape) != (b, h, w):
        raise ValueError(f'cell {tuple(cell.shape)} vs x {tuple(x.shape)}')
    plan = splat_tiles_plan(gc, c, t)
    nty, ntx = -(-h // t), -(-w // t)
    part = torch.empty((b, nty, ntx, 4, gc, gc, gc, c), dtype=torch.float32,
                       device=x.device)
    fn = _build.entry('bilateral_splat_tiles',
                      (_P, _P, _P, _P) + (_I,) * 15 + (_P,))
    rc = fn(x.data_ptr(), cell.data_ptr(),
            _tile_weights(t, x.device).data_ptr(), part.data_ptr(), b, h, w,
            c, t, nty, ntx, gc ** 3, plan.cells, plan.ranges, plan.chunk,
            plan.seg, plan.smem_bytes,
            _even_blocks(b * nty * ntx * plan.ranges, plan.blocks_per_sm,
                         x.device), plan.threads, _stream())
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


# the fold's persistent blocks: 256 threads, at most 64 registers, 4 an
# SM; a thread loads 2 float4s (or 8 floats) from every source a step
_FOLD_THREADS = 256
_FOLD_BLOCKS_PER_SM = 4
_FOLD_WORDS = 2
# a unit's fixed cost (its first loads' round trip), in steps
_FOLD_UNIT_COST = 1


@dataclasses.dataclass(frozen=True)
class FoldPlan:
    """How ``bilateral_fold`` cuts the grid of `nodes` nodes of gc^3 C
    floats each.

    A unit of work is a node and a span of `span` floats of its cube
    (`spans` of them a node, the last ragged; ``cut()``); units are
    numbered node by node.  `vec` 4: the cube is a multiple of 4 floats,
    so every cube starts 16-byte aligned and a thread moves float4s;
    `vec` 1: 4-byte words.  A step is `step` floats: every thread's words
    of one round of loads."""
    gc: int
    c: int
    nodes: int
    vec: int
    span: int
    spans: int

    @property
    def cube(self) -> int:
        return self.gc ** 3 * self.c

    @property
    def step(self) -> int:
        return _FOLD_THREADS * _FOLD_WORDS * 4

    @property
    def units(self) -> int:
        return self.nodes * self.spans

    def cut(self) -> List[Tuple[int, int]]:
        """(first float, floats) of each span of a node's cube, in order."""
        return [(e0, min(self.span, self.cube - e0))
                for e0 in range(0, self.cube, self.span)]


@functools.lru_cache(maxsize=None)
def fold_plan(gc: int, c: int, nodes: int) -> FoldPlan:
    """The geometry of ``bilateral_fold`` for `nodes` nodes of gc^3 C
    floats: 16-byte words where the cube is a multiple of 4 floats, else
    4-byte words; then the number of spans a cube is cut into (of whole
    steps) that finishes soonest on 132 SMs of 4 blocks each: a block's
    units in turn, each its steps and a fixed cost of one step (the fewer
    spans on a tie).  ValueError where a cube or the units do not fit the
    kernel's 32-bit indices."""
    if gc < 1 or c < 1 or nodes < 1:
        raise ValueError(f'bilateral_fold takes gc >= 1, C >= 1 and nodes '
                         f'>= 1, got gc={gc}, C={c}, nodes={nodes}')
    cube = gc ** 3 * c
    step = _FOLD_THREADS * _FOLD_WORDS * 4
    if 2 * cube + step >= 2 ** 31:               # a span's end, in int
        raise ValueError(f'bilateral_fold: no plan fits gc={gc}, C={c}: a '
                         f'cube of {cube} floats is past the kernel\'s '
                         f'32-bit indices')
    vec = 4 if cube % 4 == 0 else 1
    steps = -(-cube // step)                      # steps of a whole cube
    slots = _SMS * _FOLD_BLOCKS_PER_SM

    def cost(n):
        span = -(-steps // n) * step
        spans = -(-cube // span)
        return (-(-nodes * spans // slots) * (span // step + _FOLD_UNIT_COST),
                spans, span)
    _, spans, span = min(cost(n) for n in range(1, steps + 1))
    if nodes * spans >= 2 ** 31:
        raise ValueError(f'bilateral_fold: no plan fits gc={gc}, C={c}, '
                         f'nodes={nodes}: {nodes * spans} units are past the '
                         f'kernel\'s 32-bit indices')
    return FoldPlan(gc, c, nodes, vec, span, spans)


def bilateral_fold(part: torch.Tensor) -> torch.Tensor:
    """partials [B,nty,ntx,4,gc,gc,gc,C] f32 -> grid
    [B,nty+1,ntx+1,gc,gc,gc,C], no blur (one launch of persistent blocks
    over (node, span) units; bit-equal to the plain version)."""
    if not _use_kernel(part):
        return bilateral_fold_plain(part)
    b, nty, ntx, gc, c = _check_partials(part)
    nodes = b * (nty + 1) * (ntx + 1)
    plan = fold_plan(gc, c, nodes)
    grid = torch.empty((b, nty + 1, ntx + 1, gc, gc, gc, c),
                       dtype=torch.float32, device=part.device)
    blocks = _even_blocks(plan.units, _FOLD_BLOCKS_PER_SM, part.device)
    fn = _build.entry('bilateral_fold', (_P, _P) + (_I,) * 9 + (_P,))
    rc = fn(part.data_ptr(), grid.data_ptr(), nty + 1, ntx + 1, plan.cube,
            plan.vec, plan.span, plan.spans, plan.units, blocks,
            -(-plan.units // blocks), _stream())
    LAUNCHES['bilateral_fold'] += 1
    _raise_on(rc, 'bilateral_fold')
    return grid


# the v1 route's two cube blurs (fold + blur, blur): a (cg, channel) row
# in registers up to gc 24 (K2's row phase) where at least 256 rows keep
# half the block busy, in blocks of 512 threads at up to 128 registers;
# else element-parallel cg and cb passes through a second shared-memory
# plane, in blocks of 128-256 threads at up to 64 registers
_CUBE_BLUR_REG_GC = 24
_CUBE_BLUR_REG_ROWS = 256
# channels of a group where whole planes of all C do not fit: 8 floats are
# one 32-byte sector, small enough for two blocks an SM
_CUBE_BLUR_GROUP = 8
# for the choice of slabs: a unit's fixed cost (its first planes' round
# trip, the steps' barriers) in plane steps; the bytes an SM moves in one
# plane step's time (~25 GB/s, an SM's share of the memory rate, over ~1 us
# a step)
_CUBE_BLUR_UNIT_COST = 4
_CUBE_BLUR_STEP_BYTES = 25600


@dataclasses.dataclass(frozen=True)
class CubeBlurPlan:
    """How ``bilateral_cube_blur`` (corners 1) and ``bilateral_fold_blur``
    (corners 4: the fold's four partials) cut a node's [gc, gc, gc, C]
    cube.

    A unit of work is a node, a slab of `nl` output cr-planes (`slabs`
    of them, the last ragged; ``slab_cut()``) and a group of `nc`
    consecutive channels (``channel_groups()``).  A block streams the
    slab's input planes (the slab and 2 planes of halo each side, inside
    the cube) through shared memory with cp.async copies (16-byte words
    where aligned): one plane (all C: one contiguous span; fewer: gc^2
    runs of nc) a slot of `slot` floats.  Corners 1: a ring of 5 + `in_flight` slots, from float
    0.  Corners 4: a landing area of `in_flight` planes of 4 slots (the
    four partials' planes, in flight) from float 0, folded into a ring of
    5 slots from float `buf_ring`.  Then the work plane A ([gc + 4][gc][nc]
    from float `buf_a`, 3 floats of room to align it) and, for the
    element-parallel row phase (`reg_rows` false), the plane B from float
    `buf_b`."""
    gc: int
    c: int
    corners: int
    nc: int
    slabs: int
    nl: int
    in_flight: int
    reg_rows: bool
    slot: int
    buf_ring: int
    buf_a: int
    buf_b: int
    smem_bytes: int
    threads: int
    blocks_per_sm: int

    @property
    def groups(self) -> int:
        return -(-self.c // self.nc)

    def channel_groups(self) -> List[Tuple[int, int]]:
        """(first channel, channels) of each group, in unit order."""
        return [(c0, min(self.nc, self.c - c0))
                for c0 in range(0, self.c, self.nc)]

    def slab_cut(self) -> List[Tuple[int, int]]:
        """(first output plane, planes) of each slab, in unit order."""
        return [(l0, min(self.nl, self.gc - l0))
                for l0 in range(0, self.gc, self.nl)]


def _cube_blur_layout(gc: int, nc: int, whole: bool, corners: int, f: int,
                      reg_rows: bool):
    """(slot, buf_ring, buf_a, buf_b, smem bytes) of one plan."""
    plane = gc * gc * nc
    # a whole plane lands at a 0-3 float offset in its slot
    slot = _round4(plane + 3) if whole else _round4(plane)
    if corners == 1:
        buf_ring = 0
        buf_a = (5 + f) * slot
    else:
        buf_ring = f * corners * slot
        buf_a = buf_ring + 5 * _round4(plane)
    buf_b = buf_a + _round4((gc + 4) * gc * nc + 3)
    end = buf_b + (0 if reg_rows else _round4(plane))
    return slot, buf_ring, buf_a, buf_b, 4 * end


@functools.lru_cache(maxsize=None)
def cube_blur_plan(gc: int, c: int, corners: int, nodes: int
                   ) -> CubeBlurPlan:
    """The geometry of the v1 route's cube blurs for gc colour cells an
    axis, C channels, `corners` partials a plane (1: the grid, 4: the
    fold's) and `nodes` nodes: whole planes of all C where a pipeline of
    them fits a block, else even groups of up to 8 consecutive channels
    (of a multiple of 4 where C is one, so that their runs copy in
    16-byte words); the row phase in registers where a plane has >= 256
    (cg, channel) rows and gc <= 24; up to 3 planes in flight, as many as
    keep two blocks an SM where one plane in flight allows two; then the
    number of cr slabs a node is cut into that finishes soonest on 132
    SMs: the longer of a block's chain of plane steps and the busiest
    SM's bytes over its share of the memory rate (the finer cut on a
    tie).  ValueError where not even one channel's planes fit a block."""
    if gc < 1 or c < 1 or corners not in (1, 4) or nodes < 1:
        raise ValueError(f'cube blur takes gc >= 1, C >= 1, corners 1 or 4 '
                         f'and nodes >= 1, got gc={gc}, C={c}, '
                         f'corners={corners}, nodes={nodes}')

    def fit(nc):
        """(in_flight, reg_rows, layout, threads, blocks an SM), or None:
        the most planes in flight that keep two blocks an SM where one
        plane in flight allows two."""
        reg = gc <= _CUBE_BLUR_REG_GC and gc * nc >= _CUBE_BLUR_REG_ROWS
        threads = 512 if reg else min(256, max(128, _pow2(gc * gc * nc // 4)))
        found = []
        for f in (1, 2, 3):
            layout = _cube_blur_layout(gc, nc, nc == c, corners, f, reg)
            if layout[-1] > SMEM_BLOCK:
                break
            bps = 1 if reg else min(_blocks_per_sm(layout[-1], threads),
                                    65536 // (threads * 64))
            found.append((f, reg, layout, threads, bps))
        want = min(2, found[0][-1]) if found else 0
        return ([p for p in found if p[-1] >= want] or [None])[-1]

    # whole planes of all C, else groups of up to 8 channels (of 4 or 8
    # where C is a multiple of 4: runs that copy in 16-byte words), as
    # even as their number allows
    if fit(c) is not None:
        nc = c
    else:
        for nc in range(min(c, _CUBE_BLUR_GROUP), 0, -1):
            if fit(nc) is not None:
                break
        else:
            raise ValueError(f'cube blur: no plan fits a block of '
                             f'{SMEM_BLOCK} bytes for gc={gc}, C={c}, '
                             f'corners={corners}: not even one channel\'s '
                             f'planes')
        if c % 4 == 0 and nc >= 4:
            nc = nc // 4 * 4
        else:
            nc = -(-c // -(-c // nc))
    f, reg, (slot, buf_ring, buf_a, buf_b, smem), threads, bps = fit(nc)
    groups = -(-c // nc)

    def cost(slabs):
        # the longer of a block's chain of plane steps (its units in turn,
        # each its planes read and written and a fixed cost) and the
        # busiest SM's bytes
        nl = -(-gc // slabs)
        n = -(-gc // nl)                       # slabs of nl planes
        cut = [(min(gc, l0 + nl + 2) - max(0, l0 - 2), min(nl, gc - l0))
               for l0 in range(0, gc, nl)]
        units = nodes * groups * n
        steps = -(-units // (_SMS * bps)) * (
            max(i + o for i, o in cut) + _CUBE_BLUR_UNIT_COST)
        moved = -(-units // _SMS) * max(i * corners + o for i, o in cut) \
            * 4 * gc * gc * nc / _CUBE_BLUR_STEP_BYTES
        return max(steps, moved), -n, nl

    _, slabs, nl = min(cost(s) for s in range(1, gc + 1))
    slabs = -slabs
    return CubeBlurPlan(gc, c, corners, nc, slabs, nl, f, reg, slot,
                        buf_ring, buf_a, buf_b, smem, threads, bps)


def bilateral_fold_blur_plain(part: torch.Tensor, taps: Sequence[float],
                              ref_round: bool = False) -> torch.Tensor:
    """Plain fold then colour blur; ref_round keeps the folded cube in
    f32 and rounds the blurred one to bf16 (:592)."""
    return bilateral_color_blur_plain(bilateral_fold_plain(part), taps,
                                      ref_round=ref_round)


def bilateral_fold_blur(part: torch.Tensor, taps: Sequence[float]
                        ) -> torch.Tensor:
    """partials [B,nty,ntx,4,gc,gc,gc,C] f32 -> folded grid blurred along
    cr, cg, cb, in one launch that reads each partial once and writes the
    grid once (bit-equal to the plain version)."""
    if not _use_kernel(part):
        return bilateral_fold_blur_plain(part, taps)
    b, nty, ntx, gc, c = _check_partials(part)
    nodes = b * (nty + 1) * (ntx + 1)
    plan = cube_blur_plan(gc, c, 4, nodes)
    t0, t1, t2 = (float(v) for v in taps)
    grid = torch.empty((b, nty + 1, ntx + 1, gc, gc, gc, c),
                       dtype=torch.float32, device=part.device)
    fn = _build.entry('bilateral_fold_blur',
                      (_P, _P) + (_I,) * 18 + (_F, _F, _F, _P))
    rc = fn(part.data_ptr(), grid.data_ptr(), b, nty + 1, ntx + 1, gc, c,
            plan.nc, plan.groups, plan.slabs, plan.nl, plan.in_flight,
            int(plan.reg_rows), plan.slot, plan.buf_ring, plan.buf_a,
            plan.buf_b, plan.smem_bytes,
            _even_blocks(nodes * plan.slabs * plan.groups,
                         plan.blocks_per_sm, part.device),
            plan.threads, t0, t1, t2, _stream())
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
    nodes = grid.shape[0] * grid.shape[1] * grid.shape[2]
    plan = cube_blur_plan(gc, c, 1, nodes)
    t0, t1, t2 = (float(v) for v in taps)
    out = torch.empty_like(grid)
    fn = _build.entry('bilateral_cube_blur',
                      (_P, _P, _LL) + (_I,) * 14 + (_F, _F, _F, _P))
    rc = fn(grid.data_ptr(), out.data_ptr(), nodes, gc, c, plan.nc,
            plan.groups, plan.slabs, plan.nl, plan.in_flight,
            int(plan.reg_rows), plan.slot, plan.buf_a, plan.buf_b,
            plan.smem_bytes,
            _even_blocks(nodes * plan.slabs * plan.groups,
                         plan.blocks_per_sm, grid.device),
            plan.threads, t0, t1, t2, _stream())
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


# the aligned slice's warps copy runs of 32 pixels x C floats, indexed in
# 32 bits
_SLICE_ALIGNED_MAX_C = 8192


def bilateral_slice_aligned(grid: torch.Tensor, cell: torch.Tensor, t: int
                            ) -> torch.Tensor:
    """aligned grid [B,nty,ntx,gc,gc,gc,C] f32, cell [B,H,W] int32 ->
    [B,H,W,C] (one launch, a warp a run of 32 pixels; bit-equal to the
    plain version)."""
    if not _use_kernel(grid, cell):
        return bilateral_slice_aligned_plain(grid, cell, t)
    gc, c = _check_grid(grid)
    _check(cell, 'cell', torch.int32, 3)
    b, nty, ntx = grid.shape[:3]
    h, w = cell.shape[1:]
    if cell.shape[0] != b or nty != -(-h // t) or ntx != -(-w // t):
        raise ValueError(f'cell {tuple(cell.shape)} does not fit aligned '
                         f'grid {tuple(grid.shape)} at t={t}')
    if grid.numel() // c >= 2 ** 31 or c > _SLICE_ALIGNED_MAX_C:
        raise ValueError(f'aligned grid {tuple(grid.shape)}: the kernel '
                         f'takes under 2^31 rows and C <= '
                         f'{_SLICE_ALIGNED_MAX_C}')
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


_FLAT_BLUR_MAX_PASSES = 3
# the most positions a block owns across pass 0's stride, and the fewest
# windows a launch should have: two for each of an H100's 132 SMs
_FLAT_BLUR_MAX_WINDOW = 8192
_FLAT_BLUR_UNITS = 2 * 132
# pass 0 strides below which a block takes tiles of a stripe
_FLAT_BLUR_TILE_BELOW = 2048


@dataclasses.dataclass(frozen=True)
class FlatBlurPlan:
    """How ``flat_color_blur`` cuts x [n_stripes, L].

    A block owns `window` positions [a, a + lc) of a stripe inside `walk`
    (`windows` of them, the last ragged; ``cut()``) and walks `steps`
    steps along it: step k covers k * walk + [a, a + lc).  On the walk
    (`walk` = pass 0's stride) pass 0's taps are the windows of steps
    k - r0 .. k + r0; a tile (`walk` = L, one step) carries pass 0's
    reach r0 * stride in its own window instead (`reach`), for strides
    too short to walk along.  Pass p's window reaches halos[p] beyond the
    block's positions on each side (the last pass's 0).  The ring holds
    `ring` input windows of `slot` floats; pass 0 writes its window over
    the oldest of them on the walk, from float `buf_y0` on for a tile;
    pass 1's starts at float `buf0`."""
    length: int
    stride: int
    walk: int
    reach: int
    halos: Tuple[int, ...]
    taps0: int
    window: int
    windows: int
    steps: int
    in_flight: int
    slot: int
    buf_y0: int
    buf0: int
    smem_bytes: int
    threads: int
    blocks_per_sm: int

    @property
    def tile(self) -> bool:
        return self.walk != self.stride

    @property
    def ring(self) -> int:
        return (1 if self.tile else self.taps0) + self.in_flight

    def cut(self) -> List[Tuple[int, int]]:
        """(a, lc): the positions [a, a + lc) of each window of a walk."""
        return [(a, min(self.window, self.walk - a))
                for a in range(0, self.walk, self.window)]


def _check_passes(passes: Sequence[Pass]) -> None:
    for taps, stride in passes:
        if not 1 <= len(taps) <= _FLAT_BLUR_MAX_TAPS or len(taps) % 2 == 0:
            raise ValueError(f'flat_color_blur takes an odd number of taps '
                             f'up to {_FLAT_BLUR_MAX_TAPS}, got {len(taps)}')
        if stride < 1:
            raise ValueError(f'stride {stride} < 1')


def flat_blur_plan(n_stripes: int, length: int, passes: Sequence[Pass]
                   ) -> FlatBlurPlan:
    """The geometry of ``flat_color_blur`` for `n_stripes` stripes of
    `length` and a chain of 1-3 passes.  A block walks along pass 0's
    stride, or takes tiles of a stripe where that stride is under 2048.
    Its window is the widest (up to 8192 positions, and narrow enough for
    264 windows in all where the walk and the halos allow; the windows of
    a walk as even as they come) whose ring, with 2 windows in flight,
    fits a block; else with 1 in flight.  ValueError when not even a
    one-position window fits (a halo too wide for a block)."""
    _check_passes(passes)
    if not 1 <= len(passes) <= _FLAT_BLUR_MAX_PASSES:
        raise ValueError(f'flat_color_blur takes 1-{_FLAT_BLUR_MAX_PASSES} '
                         f'passes in one launch, got {len(passes)}')
    return _flat_blur_plan(n_stripes, length,
                           tuple((len(t), int(st)) for t, st in passes))


@functools.lru_cache(maxsize=None)
def _flat_blur_plan(n_stripes: int, length: int,
                    chain: Tuple[Tuple[int, int], ...]) -> FlatBlurPlan:
    """flat_blur_plan for passes of (taps, stride) counts `chain`."""
    n = len(chain)
    strides = [st for _, st in chain]
    halos = [0] * n
    for p in range(n - 2, -1, -1):
        halos[p] = halos[p + 1] + (chain[p + 1][0] - 1) // 2 * strides[p + 1]
    s0, n0 = strides[0], chain[0][0]
    avail = SMEM_BLOCK - 4 * _FLAT_BLUR_MAX_TAPS      # static: tap offsets

    def plan(tile):
        walk = length if tile else s0
        reach = (n0 - 1) // 2 * s0 if tile else 0
        ring = 1 if tile else n0

        def layout(lc, f):
            # on the walk pass 0's window overwrites a ring slot; pass 1's
            # has its own; float4 reads of pass 1 run up to 3 floats past
            # a buffer's end
            slot = _round4(lc + 2 * (halos[0] + reach) + 3)
            buf_y0 = (ring + f) * slot
            y0 = _round4(lc + 2 * halos[0] + 3) + 4 if tile and n >= 2 else 0
            y1 = _round4(lc + 2 * halos[1] + 3) if n == 3 else 0
            return slot, buf_y0, buf_y0 + y0, 4 * (buf_y0 + y0 + y1 + 4)

        # windows a walk for 264 in all, but none narrower than its halos
        rows = -(-_FLAT_BLUR_UNITS // max(1, n_stripes))
        want = min(walk, _FLAT_BLUR_MAX_WINDOW,
                   max(_round4(-(-walk // rows)),
                       _round4(2 * (halos[0] + reach))))
        for f in (2, 1):
            lc = want
            while lc >= 1 and layout(lc, f)[3] > avail:
                lc = min(lc - 1, lc * avail // layout(lc, f)[3])
            if lc < 1 or (f == 2 and lc < want):
                continue
            nwin = -(-walk // lc)
            even = -(-walk // nwin)
            if _round4(even) <= lc:
                even = _round4(even)
            window = min(even, walk)
            slot, buf_y0, buf0, smem = layout(window, f)
            threads = min(512, max(128, _pow2((window + 2 * halos[0]) // 4)))
            return FlatBlurPlan(
                length, s0, walk, reach, tuple(halos), n0, window,
                -(-walk // window), -(-length // walk), f, slot, buf_y0,
                buf0, smem, threads,
                _blocks_per_sm(smem + 4 * _FLAT_BLUR_MAX_TAPS, threads))
        return None

    # a stride too short to walk along gives steps of a few hundred
    # positions, each with its syncs: take tiles instead
    tile = s0 < _FLAT_BLUR_TILE_BELOW and s0 < length
    found = plan(tile) or (plan(False) if tile else None)
    if found is None:
        raise ValueError(f'flat_color_blur: no plan fits a block of '
                         f'{SMEM_BLOCK} bytes for L={length}, strides '
                         f'{strides}, taps {[t for t, _ in chain]}: pass '
                         f'0\'s halo of {halos[0]} positions is too wide')
    return found


def flat_color_blur(x: torch.Tensor, passes: Sequence[Pass]
                    ) -> torch.Tensor:
    """x [n_stripes, L] f32 -> the same shape after a chain of 1-3
    passes, in one launch that reads x once and writes the result once
    (bit-equal to the plain version).  No passes: x itself."""
    if not _use_kernel(x):
        return flat_color_blur_plain(x, passes)
    _check(x, 'x', torch.float32, 2)
    _check_passes(passes)
    if not passes:
        return x
    n_stripes, length = x.shape
    plan = flat_blur_plan(n_stripes, length, passes)
    n = len(passes)
    taps = (_F * (_FLAT_BLUR_MAX_PASSES * _FLAT_BLUR_MAX_TAPS))()
    for p, (k, _) in enumerate(passes):
        for j, v in enumerate(k):
            taps[p * _FLAT_BLUR_MAX_TAPS + j] = float(v)
    n_taps = (_I * n)(*(len(k) for k, _ in passes))
    strides = (_LL * n)(*(int(st) for _, st in passes))
    halos = (_I * n)(*plan.halos)
    out = torch.empty_like(x)
    fn = _build.entry('flat_color_blur',
                      (_P, _P, _LL, _LL, _I, ctypes.POINTER(_F),
                       ctypes.POINTER(_I), ctypes.POINTER(_LL),
                       ctypes.POINTER(_I), _I, _I, _LL) + (_I,) * 8 + (_P,))
    rc = fn(x.data_ptr(), out.data_ptr(), n_stripes, length, n, taps, n_taps,
            strides, halos, plan.window, plan.windows, plan.steps,
            plan.in_flight, plan.slot, plan.buf0, int(plan.tile),
            plan.buf_y0, plan.smem_bytes,
            _blocks(n_stripes * plan.windows, plan.blocks_per_sm, x.device),
            plan.threads, _stream())
    LAUNCHES['flat_color_blur'] += 1
    _raise_on(rc, 'flat_color_blur')
    return out


# ---------------------------------------------------------------------------
# direct window
# ---------------------------------------------------------------------------

class WindowTable:
    """A direct window's offsets as ``direct_window`` reads them: `rows`,
    one a dy from `dy0` on, each the run of dx ``lo..hi`` (an empty run
    where the window skips a dy), and the spatial weights as a dense
    table [2 rx + 1][ndy + 14], ``dense[dx + rx][dy - dy0 + 7]``: 0
    where (dy, dx) is no offset and in the 7 zero rows at each end (a
    kernel thread's pixels reach 7 rows past the table).  ValueError
    unless the offsets are rows of consecutive dx, dy ascending (the form
    the plain version's row-at-a-time loop assumes too)."""

    def __init__(self, offs: Sequence[Tuple[int, int]],
                 wspace: Sequence[float]):
        if not offs or len(offs) != len(wspace):
            raise ValueError(f'direct window: {len(offs)} offsets and '
                             f'{len(wspace)} spatial weights')
        rows: List[Tuple[int, int]] = []
        dy0 = offs[0][0]
        for i, (dy, dx) in enumerate(offs):
            if rows and dy == dy0 + len(rows) - 1:
                lo, hi = rows[-1]
                if dx != hi + 1:
                    raise ValueError(f'direct window: offset {i} ({dy}, '
                                     f'{dx}) does not extend the run of '
                                     f'dy {dy} ({lo}..{hi})')
                rows[-1] = (lo, dx)
                continue
            if dy < dy0 + len(rows):
                raise ValueError(f'direct window: offset {i} ({dy}, {dx}) '
                                 'is out of dy order')
            rows += [(1, 0)] * (dy - dy0 - len(rows))   # a dy skipped
            rows.append((dx, dx))
        self.dy0 = dy0
        self.rows = tuple(rows)
        self.rx = max(max(-dx, dx) for _, dx in offs)
        nk = len(rows) + 2 * _WINDOW_PAD
        dense = [0.0] * ((2 * self.rx + 1) * nk)
        for (dy, dx), v in zip(offs, wspace):
            dense[(dx + self.rx) * nk + dy - dy0 + _WINDOW_PAD] = float(v)
        self.dense = dense
        self._dev: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def ndy(self) -> int:
        return len(self.rows)

    def on(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """rows [ndy, 2] int32 and the dense weights float32 on `device`,
        copied there once."""
        if device not in self._dev:
            self._dev[device] = (
                torch.tensor(self.rows, dtype=torch.int32, device=device),
                torch.tensor(self.dense, dtype=torch.float32, device=device))
        return self._dev[device]


# zero rows at each end of WindowTable.dense (csrc/direct_window.cu: kPad)
_WINDOW_PAD = 7
# the most channels a block takes (registers: G accumulators a pixel)
_WINDOW_MAX_G = 32
# the channel widths built (csrc/direct_window.cu: DW_CASE): the paths'
# C 1, 5, 21 and 29, and powers of two between
_WINDOW_G = (1, 2, 4, 5, 8, 16, 21, 29, 32)
# accumulators a thread, P pixels x G channels (csrc/direct_window.cu:
# rows_of)
_WINDOW_ACCS = 128


def _window_rows(g: int) -> int:
    """Pixels (rows) a thread owns for g channels a thread."""
    return max(1, min(_WINDOW_PAD + 1, _WINDOW_ACCS // g))


def _window_slot(g: int, rx: int) -> int:
    """Floats a ring slot: 32 + 2 rx pixels of the guide (4 floats) and
    of x (g | 1 floats), rounded up to 16 bytes
    (csrc/direct_window.cu: slot_floats)."""
    return _round4((32 + 2 * rx) * (4 + (g | 1)))


@dataclasses.dataclass(frozen=True)
class DirectWindowPlan:
    """How ``direct_window`` cuts [B, H, W, C]: blocks of one warp, each
    `p` rows x 32 columns of one image and `g` channels (`groups`
    groups; the last may hold fewer), walking the window's rows through
    a ring of two slots (``_window_slot``)."""
    g: int
    groups: int
    p: int
    smem_bytes: int
    grid: Tuple[int, int, int]


@functools.lru_cache(maxsize=None)
def direct_window_plan(b: int, h: int, w: int, c: int, rx: int
                       ) -> DirectWindowPlan:
    """The geometry of ``direct_window`` for B images of H x W, C
    channels and a window reaching `rx` columns each side: the fewest
    channel groups of at most 32 (every group computes its own weights),
    each as wide as the narrowest width built that holds an even share
    (the last group's channels past C are zeros); rows a thread by the
    channels (about 128 accumulators a thread, 1-8 rows); a warp a block
    (the card's tail of small blocks is short).  ValueError for an empty shape or a window
    whose two staged rows do not fit a block."""
    if min(b, h, w, c) < 1 or rx < 0:
        raise ValueError(f'direct_window takes a non-empty shape and '
                         f'window, got B={b} H={h} W={w} C={c} rx={rx}')
    groups = -(-c // _WINDOW_MAX_G)
    g = min(k for k in _WINDOW_G if k >= -(-c // groups))
    p = _window_rows(g)
    smem = 2 * _window_slot(g, rx) * 4
    if smem > SMEM_BLOCK:
        raise ValueError(f'direct_window: no block of {SMEM_BLOCK} bytes '
                         f'holds two staged rows of {32 + 2 * rx} pixels '
                         f'and {g} channels (rx={rx})')
    return DirectWindowPlan(g, groups, p, smem,
                            (-(-w // 32), -(-h // p), b * groups))


def direct_window(img: torch.Tensor, x: torch.Tensor, table: WindowTable,
                  srgb: float) -> torch.Tensor:
    """The direct window of guides img [B,H,W,3] on x [B,H,W,C], both
    float32 on the card: for each pixel p, the sum over the table's
    offsets o with p + o in the image of
    ``ws[o] * exp(-|I[p] - I[p+o]|^2 / (2 srgb^2)) * x[p + o]``, in one
    launch (the plain version: ``meanfield.DirectBilateral._filter``).
    Raises for CPU tensors and for a type or shape it does not take."""
    if not _use_kernel(img, x):
        raise ValueError('direct_window launches on CUDA tensors only '
                         '(the plain version is DirectBilateral._filter)')
    _check(img, 'img', torch.float32, 4)
    _check(x, 'x', torch.float32, 4)
    b, h, w, c = x.shape
    if tuple(img.shape) != (b, h, w, 3):
        raise ValueError(f'direct_window: guide {tuple(img.shape)} for x '
                         f'{tuple(x.shape)}')
    plan = direct_window_plan(b, h, w, c, table.rx)
    rows, dense = table.on(x.device)
    out = torch.empty_like(x)
    fn = _build.entry('direct_window',
                      (_P,) * 5 + (_I,) * 7 + (_F,) + (_I,) * 4 + (_P,))
    rc = fn(img.data_ptr(), x.data_ptr(), out.data_ptr(), rows.data_ptr(),
            dense.data_ptr(), b, h, w, c, table.dy0, table.ndy, table.rx,
            -0.5 / (srgb * srgb), plan.g, plan.p, plan.groups,
            plan.smem_bytes, _stream())
    LAUNCHES['direct_window'] += 1
    _raise_on(rc, 'direct_window')
    return out
