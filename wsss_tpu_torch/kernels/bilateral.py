"""The three bilateral-grid kernels of the CRF's main path, each with its
plain PyTorch version and a launch counter.

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

Each wrapper launches ``csrc/<its name>.cu`` and replaces, in
wsss_tpu/ops/crf/mxu_grid.py:
  * bilateral_splat       _splat_kernel_v2 and the fold of
                          _combine_blur_kernel_v2;
  * bilateral_color_blur  the colour blur of _combine_blur_kernel_v2;
  * bilateral_slice       _slice_kernel as _slice_v2 calls it.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Sequence

import torch

from wsss_tpu_torch.kernels import build as _build

# launches of each kernel, counted where the wrapper launches it (one per
# CUDA launch: bilateral_color_blur launches three, one per colour axis)
LAUNCHES: Dict[str, int] = {'bilateral_splat': 0,
                            'bilateral_color_blur': 0,
                            'bilateral_slice': 0}

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
    after — only to make CPU parity tests tight."""
    b, h, w, c = x.shape
    gc3 = gc ** 3
    if not ref_round:
        grid = torch.zeros(b * gy * gx * gc3, c, dtype=torch.float32,
                           device=x.device)
        for rows, wq in corner_rows(cell, t, gy, gx, gc3):
            grid.index_add_(0, rows.reshape(-1),
                            (wq[..., None] * x).reshape(-1, c))
        return grid.view(b, gy, gx, gc, gc, gc, c)
    nty, ntx = gy - 1, gx - 1
    part = torch.zeros(4, b * nty * ntx * gc3, c, dtype=torch.float32,
                       device=x.device)
    for q, (rows, wq) in enumerate(corner_rows(cell, t, nty, ntx, gc3,
                                               own_tile=True)):
        part[q].index_add_(0, rows.reshape(-1),
                           bf16_round(wq[..., None] * x).reshape(-1, c))
    part = bf16_round(part).view(4, b, nty, ntx, gc3, c)
    grid = torch.zeros(b, gy, gx, gc3, c, dtype=torch.float32,
                       device=x.device)
    for q in range(4):
        by, bx = divmod(q, 2)
        grid[:, by:by + nty, bx:bx + ntx] += part[q]
    return grid.view(b, gy, gx, gc, gc, gc, c)


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


def bilateral_color_blur(grid: torch.Tensor, taps: Sequence[float]
                         ) -> torch.Tensor:
    """grid [B,gy,gx,gc,gc,gc,C] f32 -> the same shape, blurred along the
    three colour axes (three launches, one per axis)."""
    if not _use_kernel(grid):
        return bilateral_color_blur_plain(grid, taps)
    _check(grid, 'grid', torch.float32, 7)
    gc, c = grid.shape[3], grid.shape[6]
    if grid.shape[4] != gc or grid.shape[5] != gc:
        raise ValueError(f'grid colour axes {tuple(grid.shape[3:6])}')
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
