"""Bilateral-grid filter of the dense CRF (counterpart of
``wsss_tpu/ops/crf/mxu_grid.py``'s ``MXUBilateralGrid``).

The filter approximates ``K @ x`` per image, with
``K = exp(-|dp|^2 / 2 sxy^2 - |dI|^2 / 2 srgb^2)`` (self weight 1):

  * splat:  each pixel adds its value, times its 4 bilinear spatial
    weights, into its nearest colour cell of the 4 grid nodes around it
    (spatial cells of t = sxy/k pixels, colour cells of cell_mult*srgb);
  * blur:   radius-2 Gaussian taps along the 3 colour axes (zero fill),
    then one Kronecker band-matrix product over the gy*gx spatial nodes;
  * slice:  each pixel reads back its colour cell of the same 4 nodes
    with the same weights.

The geometry (cell sizes, blur sigmas calibrated for the interpolation
variance, routing limits) is the reference's, copied here.  The grid
itself is laid out canonically, ``[B, gy, gx, gc, gc, gc, C]`` f32: the
TPU's one-hot matmuls and lane packing do not carry over (see
``wsss_tpu_torch/kernels/bilateral.py`` for the kernels and their plain
versions).  The spatial blur stays a matrix product, as the reference
leaves it to XLA.

A filter takes one of the reference's three kernel routes, chosen as
``MXUBilateralGrid.__init__`` chooses there (mxu_grid.py :663-666,
:799-801), each kernel standing for the reference's of that route:

  route       taken when                    splat -> ... -> slice
  v2          C <= 32 and the v2 bounds     bilateral_splat (K1 + K2's
              hold, WSSS_TPU_MXU_V1 unset   fold) -> bilateral_color_blur
                                            (K2's blur) -> spatial ->
                                            bilateral_slice (K3)
  v1 fused    v2 off, four whole partials   bilateral_splat_tiles (K4) ->
              fit the reference's VMEM      bilateral_fold_blur (K6) ->
              bound (fuse_combine_blur)     spatial -> bilateral_slice (K7)
  v1 unfused  v2 off, they do not fit       bilateral_splat_tiles (K4) ->
              (C 33..64 at gc 16)           bilateral_fold (K5) -> spatial
                                            -> bilateral_cube_blur (K8) ->
                                            bilateral_slice (K7)

The v1 kernels sum in a fixed order (no atomics): a v1 filter gives the
same bits on every run.

``AlignedBilateralGrid`` is the reference's study variant (nearest splat
and slice on cells of sxy/2 centred on the pixel tiles): no entry point
builds it there, and none does here.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from wsss_tpu_torch.kernels import bilateral as K

_BLUR_RADIUS = 2            # colour-axis taps
_MAX_TILE = 48              # spatial cell cap of the TPU tiling
# the reference leaves its Pallas colour blur for band-matrix einsums
# above this many cube elements (mxu_grid.py :787); `applicable` admits
# at most 625 000 (gc^3 * 4 * C <= 2 500 000), so no grid gets there and
# the port has no such blur
_CUBE_BLUR_MAX = 1_000_000

# WSSS_TPU_MXU_V1=1 forces the v1 route, as in the reference (:89-91)
_V2_DISABLED = os.environ.get('WSSS_TPU_MXU_V1', '') not in ('', '0')


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _spatial_cell(sxy: float, require8: bool = True):
    """(t, k): spatial cell t = round(sxy)/k with the smallest k keeping
    t <= _MAX_TILE (and, with require8, t a multiple of 8 — the routing
    of the TPU's compiled kernels, which the port follows); None if sxy
    is not an integer >= 3 or no k fits."""
    t0 = int(round(sxy))
    if abs(sxy - t0) > 1e-6 or t0 < 3:
        return None
    for k in range(1, t0 + 1):
        if t0 % k != 0 or t0 // k > _MAX_TILE:
            continue
        if require8 and (t0 // k) % 8:
            continue
        return t0 // k, k
    return None


def grid_dims(srgb: float, cell_mult: float = 1.0) -> Tuple[int, int]:
    """(cells per colour axis, colour-cube size) for nearest assignment
    of 0..255 intensities at cell size cell_mult*srgb."""
    gc = int(round(255.0 / (srgb * cell_mult))) + 1
    return gc, gc ** 3


def _v2_geometry(gc: int):
    """(gcp4, h2p, lbv) of the reference's v2 corner-tiled layout for a
    gc-cell colour cube; only its routing bounds matter here."""
    gcp4 = -(-gc // 4)
    h2p = _round_up(gc * gcp4, 16)
    lbv = 1
    for cand in range(gc, 0, -1):
        if gc % cand == 0 and cand * h2p * 512 * 2 * 2 <= 4 * 1024 * 1024:
            lbv = cand
            break
    return gcp4, h2p, lbv


def v2_eligible(srgb: float, n_ch: int, cell_mult: float = 1.0) -> bool:
    """Whether the reference runs its v2 kernels for this config on the
    compiled path: at most 32 channels and its VMEM bounds."""
    gc, _ = grid_dims(srgb, cell_mult)
    _, h2p, lbv = _v2_geometry(gc)
    return (n_ch <= 32
            and gc * h2p * 128 * (4 * 2 * 2 + 4) <= 10 * 1024 * 1024
            and lbv * h2p * 512 * 2 * 2 <= 4 * 1024 * 1024)


def v2_active(srgb: float, n_ch: int, cell_mult: float = 1.0) -> bool:
    """Whether a grid of this config takes the v2 route: eligible and
    not switched off by WSSS_TPU_MXU_V1."""
    return v2_eligible(srgb, n_ch, cell_mult) and not _V2_DISABLED


def applicable(sxy: float, srgb: float, n_ch: int = 32,
               cell_mult: float = 1.0, require8: bool = True) -> bool:
    """Whether the grid takes this kernel config — the reference's limits
    (integer cell, colour-cube sizes), so configs route as on the TPU."""
    tk = _spatial_cell(sxy, require8)
    if tk is None:
        return False
    t, _ = tk
    gc, _ = grid_dims(srgb, cell_mult)
    hip = _round_up(gc * gc, 16)
    p = _round_up(t * t, 16)
    return (gc * gc <= 4096
            and gc * 4 * n_ch <= 4096
            and hip * p * 2 * 5 <= 12 * 1024 * 1024
            and gc ** 3 * 4 * n_ch <= 2_500_000)


def _blur_taps(sigma: float) -> Tuple[float, ...]:
    x = np.arange(-_BLUR_RADIUS, _BLUR_RADIUS + 1, dtype=np.float64)
    return tuple(float(v) for v in np.exp(-0.5 * (x / sigma) ** 2))


def _band_mat(n: int, sigma: float, radius: int) -> np.ndarray:
    """[n, n] truncated-Gaussian band matrix (self weight 1)."""
    m_ = np.zeros((n, n))
    d = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    for off in range(-radius, radius + 1):
        if abs(off) < n:
            m_ += np.diag(np.full(n - abs(off), d[off + radius]), k=off)
    return m_


class MXUBilateralGrid:
    """Batched bilateral-grid filter on the guide images imgs
    [B, H, W, 3] (0..255); ``filter`` maps [B, H, W, C'] -> [B, H, W, C']
    for C' <= n_ch, on the device of imgs.

    share_from: a grid built on the same imgs/sxy/srgb/cell_mult whose
    channel-independent geometry (colour cells, blur matrices) is reused
    — the CRF's C=1 normalizer grid shares the message grid's, and with
    it the v1 route when the message grid is on it.
    require8=False admits cells that are not a multiple of 8 (the
    reference's interpret-mode geometry, for tests).
    ref_round=True runs the plain versions with bf16 rounding at the
    rounding points of the route's reference kernels — a CPU-test switch
    only.

    ``v2`` and ``fuse_combine_blur`` hold the route (module docstring)."""

    def __init__(self, imgs: torch.Tensor, sxy: float, srgb: float,
                 n_ch: int, cell_mult: float = 1.0,
                 share_from: Optional['MXUBilateralGrid'] = None,
                 require8: bool = True, ref_round: bool = False):
        if imgs.ndim != 4:
            raise ValueError('MXUBilateralGrid wants batched [B,H,W,3]')
        if not applicable(sxy, srgb, n_ch, cell_mult, require8=require8):
            raise ValueError(f'bilateral grid inapplicable for sxy={sxy} '
                             f'srgb={srgb} n_ch={n_ch}')
        b, h, w = imgs.shape[:3]
        t, k_sp = _spatial_cell(sxy, require8)
        self.bhw = (b, h, w)
        self.t, self.k_sp = t, k_sp
        self.n_ch = n_ch
        self.ref_round = ref_round
        self.nty, self.ntx = -(-h // t), -(-w // t)
        self.gy, self.gx = self.nty + 1, self.ntx + 1
        gc, _ = grid_dims(srgb, cell_mult)
        self.gc = gc
        cell = srgb * cell_mult
        # colour sigma in cell units minus the nearest-assignment variance
        # (1/12 per side); the floor keeps the taps well-formed
        self.sig_col = float(np.sqrt(max((srgb / cell) ** 2 - 1.0 / 6.0,
                                         0.05)))
        self.v2 = v2_active(srgb, n_ch, cell_mult)
        # the reference fuses the blur into the fold when four whole
        # [gc, hip, 4C] bf16 partials, double-buffered, fit 8 MB of VMEM
        hip = _round_up(gc * gc, 16)
        self.fuse_combine_blur = (gc * hip * 4 * n_ch * 2 * 8
                                  <= 8 * 1024 * 1024)
        if share_from is not None:
            s = share_from
            if (s.bhw, s.t, s.gc, s.k_sp) != (self.bhw, t, gc, k_sp):
                raise ValueError('share_from grid has different geometry '
                                 '(imgs/sxy/srgb/cell_mult must match)')
            self.v2 = self.v2 and s.v2
            self.cell, self.blur_sp, self.taps = s.cell, s.blur_sp, s.taps
            return
        idx = torch.clamp(torch.round(imgs.to(torch.float32) / cell),
                          0, gc - 1).to(torch.int32)
        self.cell = ((idx[..., 0] * gc + idx[..., 1]) * gc
                     + idx[..., 2]).contiguous()          # [B,H,W] int32
        # spatial sigma in cell units: k_sp cells minus the bilinear
        # splat+slice variance (1/6 + 1/6 per axis)
        sig_sp = float(np.sqrt(k_sp ** 2 - 1.0 / 3.0))
        rad_sp = max(2, int(np.ceil(3.0 * sig_sp)))
        self.blur_sp = torch.as_tensor(
            np.kron(_band_mat(self.gy, sig_sp, rad_sp),
                    _band_mat(self.gx, sig_sp, rad_sp)).astype(np.float32),
            device=imgs.device)                     # [gy*gx, gy*gx]
        taps5 = _blur_taps(self.sig_col)
        self.taps = taps5[_BLUR_RADIUS:]            # (centre, +-1, +-2)

    def _spatial_blur(self, grid: torch.Tensor) -> torch.Tensor:
        b = grid.shape[0]
        flat = grid.reshape(b, self.gy * self.gx, -1)
        if self.ref_round:      # bf16 operands and output (mxu_grid:1017)
            return K.bf16_round(torch.matmul(K.bf16_round(self.blur_sp),
                                             flat)).view(grid.shape)
        return torch.matmul(self.blur_sp, flat).view(grid.shape)

    def filter(self, x: torch.Tensor) -> torch.Tensor:
        """Approximate K @ x per image; x [B, H, W, C'] with C' <= n_ch
        (fewer channels are zero-padded through the grid and cut off)."""
        if tuple(x.shape[:3]) != self.bhw:
            raise ValueError(f'filter input {tuple(x.shape)} does not '
                             f'match the guide {self.bhw}')
        cin = x.shape[-1]
        if cin > self.n_ch:
            raise ValueError(f'filter input has {cin} channels; grid '
                             f'built for {self.n_ch}')
        x = x.to(torch.float32)
        if cin < self.n_ch:
            x = torch.nn.functional.pad(x, (0, self.n_ch - cin))
        x = x.contiguous()
        t, gy, gx, gc = self.t, self.gy, self.gx, self.gc
        if gc ** 3 * self.n_ch > _CUBE_BLUR_MAX:
            raise ValueError(
                f'colour cube of gc^3 * C = {gc ** 3 * self.n_ch} elements '
                f'exceeds {_CUBE_BLUR_MAX}: no blur kernel of the port '
                'takes it (`applicable` admits at most 625 000)')

        def run(name, *args):
            """The kernel's wrapper, or with ref_round its plain version
            rounding where the reference kernel does."""
            if self.ref_round:
                return getattr(K, name + '_plain')(*args, ref_round=True)
            return getattr(K, name)(*args)

        if self.v2:
            grid = run('bilateral_splat', x, self.cell, t, gy, gx, gc)
            grid = run('bilateral_color_blur', grid, self.taps)
            grid = self._spatial_blur(grid)
        else:
            part = run('bilateral_splat_tiles', x, self.cell, t, gc)
            if self.fuse_combine_blur:
                grid = run('bilateral_fold_blur', part, self.taps)
                grid = self._spatial_blur(grid)
            else:       # the spatial blur comes before the colour blur
                grid = run('bilateral_fold', part)
                del part
                grid = self._spatial_blur(grid)
                grid = run('bilateral_cube_blur', grid, self.taps)
        if self.ref_round:
            out = K.bilateral_slice_plain(grid, self.cell, t)
        else:
            out = K.bilateral_slice(grid, self.cell, t)
        return out[..., :cin]


# ---------------------------------------------------------------------------
# Aligned grid: nearest splat/slice on sxy/2 cells
# ---------------------------------------------------------------------------

def aligned_applicable(sxy: float, srgb: float, n_ch: int = 32,
                       cell_mult: float = 1.0) -> bool:
    """The aligned variant needs an even integer sxy (cells of sxy/2
    centred on the tiles) and the colour-cube limits of the reference."""
    t0 = int(round(sxy))
    if abs(sxy - t0) > 1e-6 or t0 % 2 or not 3 <= t0 // 2 <= 48:
        return False
    gc, _ = grid_dims(srgb, cell_mult)
    return (gc * gc <= 4096 and gc * 4 * n_ch <= 4096
            and gc ** 3 * 4 * n_ch <= 2_500_000)


class AlignedBilateralGrid:
    """Nearest-splat / nearest-slice bilateral grid on cells of sxy/2,
    centred on the pixel tiles (counterpart of the reference's class of
    this name, mxu_grid.py:1230): each tile touches one colour cube, so
    corner weights and the fold disappear; the 2x finer spatial sampling
    makes up for the nearest interpolation, and the blur sigma absorbs
    its variance, sqrt(k^2 - 1/6) cells with k = 2.

    The grid is ``[B, nty, ntx, gc, gc, gc, C]`` f32 with the colour cell
    ``(cr * gc + cg) * gc + cb``, the reference's m-order.  The reference
    pads ntx to a multiple of its column group; those tiles hold zeros,
    which a zero-fill blur cannot see, so the port has none.

    filter = ``bilateral_splat_aligned`` -> Kronecker spatial product ->
    ``bilateral_cube_blur`` -> ``bilateral_slice_aligned``.
    ref_round=True runs the plain versions and rounds to bf16 where the
    reference does: the splat's input and output, the spatial product's
    operands and output, the cube blur's output."""

    K_SP = 2

    def __init__(self, imgs: torch.Tensor, sxy: float, srgb: float,
                 n_ch: int, cell_mult: float = 1.0, ref_round: bool = False):
        if imgs.ndim != 4:
            raise ValueError('AlignedBilateralGrid wants [B,H,W,3]')
        if not aligned_applicable(sxy, srgb, n_ch, cell_mult):
            raise ValueError(f'aligned grid inapplicable for sxy={sxy} '
                             f'srgb={srgb} n_ch={n_ch}')
        b, h, w = imgs.shape[:3]
        t = int(round(sxy)) // self.K_SP
        self.bhw = (b, h, w)
        self.t = t
        self.n_ch = n_ch
        self.ref_round = ref_round
        self.nty, self.ntx = -(-h // t), -(-w // t)
        gc, _ = grid_dims(srgb, cell_mult)
        self.gc = gc
        sig_col = float(np.sqrt(max((1.0 / cell_mult) ** 2 - 1.0 / 6.0,
                                    0.05)))
        idx = torch.clamp(torch.round(imgs.to(torch.float32)
                                      / (srgb * cell_mult)),
                          0, gc - 1).to(torch.int32)
        self.cell = ((idx[..., 0] * gc + idx[..., 1]) * gc
                     + idx[..., 2]).contiguous()          # [B,H,W] int32
        # nearest splat + slice: 1/12 + 1/12 interpolation variance
        sig_sp = float(np.sqrt(self.K_SP ** 2 - 1.0 / 6.0))
        rad_sp = max(2, int(np.ceil(3.0 * sig_sp)))
        self.blur_sp = torch.as_tensor(
            np.kron(_band_mat(self.nty, sig_sp, rad_sp),
                    _band_mat(self.ntx, sig_sp, rad_sp)).astype(np.float32),
            device=imgs.device)                     # [nty*ntx, nty*ntx]
        self.taps = _blur_taps(sig_col)[_BLUR_RADIUS:]

    def _blur(self, grid: torch.Tensor) -> torch.Tensor:
        b = grid.shape[0]
        flat = grid.reshape(b, self.nty * self.ntx, -1)
        if self.ref_round:      # bf16 operands and output (mxu_grid:1376)
            flat = K.bf16_round(torch.matmul(K.bf16_round(self.blur_sp),
                                             flat))
            return K.bilateral_cube_blur_plain(flat.view(grid.shape),
                                               self.taps, ref_round=True)
        flat = torch.matmul(self.blur_sp, flat)
        return K.bilateral_cube_blur(flat.view(grid.shape), self.taps)

    def filter(self, x: torch.Tensor) -> torch.Tensor:
        """Approximate K @ x per image; x [B, H, W, C'] with C' <= n_ch
        (fewer channels are zero-padded through the grid and cut off)."""
        if tuple(x.shape[:3]) != self.bhw:
            raise ValueError(f'filter input {tuple(x.shape)} does not '
                             f'match the guide {self.bhw}')
        cin = x.shape[-1]
        if cin > self.n_ch:
            raise ValueError(f'filter input has {cin} channels; grid '
                             f'built for {self.n_ch}')
        if self.gc ** 3 * self.n_ch > _CUBE_BLUR_MAX:
            raise ValueError(
                f'colour cube of gc^3 * C = {self.gc ** 3 * self.n_ch} '
                f'elements exceeds {_CUBE_BLUR_MAX}: the reference blurs '
                'it with band-matrix products, which the port has not '
                '(`aligned_applicable` admits at most 625 000)')
        x = x.to(torch.float32)
        if cin < self.n_ch:
            x = torch.nn.functional.pad(x, (0, self.n_ch - cin))
        x = x.contiguous()
        if self.ref_round:
            grid = self._blur(K.bilateral_splat_aligned_plain(
                x, self.cell, self.t, self.gc, ref_round=True))
            out = K.bilateral_slice_aligned_plain(grid, self.cell, self.t)
        else:
            grid = self._blur(K.bilateral_splat_aligned(
                x, self.cell, self.t, self.gc))
            out = K.bilateral_slice_aligned(grid, self.cell, self.t)
        return out[..., :cin]
