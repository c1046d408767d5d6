"""Dense-CRF mean-field inference of the port (counterpart of
``wsss_tpu/ops/crf/meanfield.py``).

Kernels of the CRF:
  * spatial Gaussian ``exp(-|dp|^2 / 2 sxy^2)``: exact, two band-matrix
    products;
  * bilateral ``exp(-|dp|^2 / 2 sxy^2 - |dI|^2 / 2 srgb^2)``: one of four
    structures, chosen from the image size and the sigmas as the
    reference chooses (``make_bilateral``, ``_mxu_ok``): the exact dense
    [N, N] kernel (``DenseBilateral``, small images), the exact truncated
    window (``DirectBilateral``, small sxy or huge colour cubes), the
    scatter grid (``BilateralGrid``: a 5-D grid filled by scatter-add,
    blurred and gathered) or the batched MXU-layout grid
    (``mxu_grid.MXUBilateralGrid``, ``_mean_field_mxu``).  For tensors
    on the CPU, a fine-colour config whose scatter grid exceeds 5 M
    cells goes to the native C++ permutohedral lattice where that
    library is built (``_fine_color_native_ok``), as in the reference;
    tensors on the card never leave it.

Both messages use symmetric normalization, ``n * (K @ (n * Q))`` with
``n = 1/sqrt(K @ 1)``; ``exclude_self`` removes the self term ``n^2 Q``
(the paper's j != i sum).  The update is
``Q <- softmax(-U + g_compat * m_g + bi_compat * m_b)``, ``U = -log p``.

Routing follows the reference's compiled TPU path: a config runs on the
MXU-layout grid iff it lands on the bilateral grid and that grid takes
it with 8-aligned spatial cells (``require8=True``).

Everything is batched over B where the reference vmaps or loops per
image; ``mean_field`` cuts a batch into chunks only to bound memory.
``ref_round=True`` (a CPU-test switch) rounds to bf16 where the
reference does; each structure says where.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch

from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.kernels.bilateral import bf16_round
from wsss_tpu_torch.ops.crf import mxu_grid as _mxu
from wsss_tpu_torch.ops.crf import native as _native
from wsss_tpu_torch.ops.filters import resize_bilinear

# the bilateral message is computed on a guide resampled to MXU_DS_CELL-px
# cells when the spatial kernel is wide (bi_sxy >= MXU_DS_MIN_SXY), and
# upsampled back bilinearly; colour cells are MXU_CELL_MULT * srgb
MXU_DS_CELL = 8
MXU_DS_MIN_SXY = 24
MXU_CELL_MULT = 1.35

# the reference's routing switches, read at import as it reads them
# (wsss_tpu/ops/crf/meanfield.py:46, :73): WSSS_TPU_NO_MXU keeps every
# config off the MXU-layout grid (``_mxu_ok``), WSSS_TPU_NO_SPATIAL_DS
# runs the grid's bilateral message at full resolution
_MXU_DISABLED = bool(os.environ.get('WSSS_TPU_NO_MXU'))
_MXU_DS_DISABLED = bool(os.environ.get('WSSS_TPU_NO_SPATIAL_DS'))

# the reference's bf16 mean-field state (meanfield.py:58): the grid
# path's loop keeps U, Q, the normalizers and the messages in bfloat16
# (the Gaussian message's products accumulate in float32), on a CUDA
# device only, as the reference's interpret mode always keeps float32.
# The reference turns it on by default on its TPU; the port keeps float32
# unless a caller sets this flag.
_CRF_STATE_BF16 = False


# the native permutohedral route (CPU tensors only) uses another
# algorithm, so which route ran changes labels; tests that want the
# scatter grid on the CPU set this
_NATIVE_DISABLED = False

# Gaussian blur inside the scatter grid, in cell units per axis
# (gy, gx, gr, gg, gb).  Splat and slice interpolation add variance
# (multilinear ~1/6 per side, nearest ~1/12), so the sigma is chosen to
# make the end-to-end kernel exp(-d^2 / 2 sigma^2):
#   'multilinear': 32-corner splat + 32-corner slice
#   'nearest':     nearest splat + 32-corner slice
#   'fast':        nearest splat + spatial-bilinear x colour-nearest slice
_GRID_BLUR_SIGMA = {
    'multilinear': (0.816,) * 5,
    'nearest': (0.866,) * 5,
    'fast': (0.866, 0.866, 0.913, 0.913, 0.913),
}
_GRID_BLUR_RADIUS = 2


def _blur_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    return np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)


def _sep_conv(x: torch.Tensor, k, axis: int) -> torch.Tensor:
    """Unnormalized 1-D convolution along `axis`, zero fill:
    ``out[i] = sum_j k[j] * x[i + j - r]``.  The centre tap first, then
    each other tap added in place on the range where it falls inside x
    (no padded copy: the scatter grid this runs on can exceed a GB)."""
    r = (len(k) - 1) // 2
    n = x.shape[axis]
    out = float(k[r]) * x
    for j in range(2 * r + 1):
        off = j - r
        if off == 0 or abs(off) >= n:
            continue
        dst = out.narrow(axis, max(0, -off), n - abs(off))
        dst.add_(x.narrow(axis, max(0, off), n - abs(off)),
                 alpha=float(k[j]))
    return out


def _flat_conv_last(x: torch.Tensor, k, stride: int) -> torch.Tensor:
    """1-D conv along a cell axis embedded in the flattened last dim:
    shifts are multiples of `stride` elements, zero-padded at the ends;
    the bleed across rows lands in margin cells (see ``_grid_shape``).
    It is one pass of the plain version of the ``flat_color_blur``
    kernel."""
    return K.flat_color_blur_plain(x, [(k, stride)])


@functools.lru_cache(maxsize=64)
def _gauss_band(n: int, sxy: float) -> np.ndarray:
    """[n, n] band matrix of the 1-D Gaussian truncated at ceil(4*sxy)
    (zero-pad convolution as a matrix product)."""
    radius = max(1, int(np.ceil(4.0 * sxy)))
    k = np.zeros((n, n))
    d = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sxy) ** 2)
    for off in range(-radius, radius + 1):
        if abs(off) < n:
            k += np.diag(np.full(n - abs(off), d[off + radius]), k=off)
    return k.astype(np.float32)


def _gaussian_filter_raw(x: torch.Tensor, sxy: float,
                         ref_round: bool = False,
                         dtype=None) -> torch.Tensor:
    """K @ x with K = exp(-|dp|^2/2 sxy^2) (self weight 1) over the two
    spatial axes of x [B, H, W, C]: one band-matrix product per axis.
    ref_round rounds the operands to bf16 as the reference's message
    does (meanfield.py:615-616).  dtype casts the operands (bf16 under
    the bf16 state; the products accumulate in float32 and, unlike the
    reference's, round to dtype between the two axes) and the result
    returns in x's dtype."""
    b0 = torch.as_tensor(_gauss_band(x.shape[1], float(sxy)),
                         device=x.device)
    b1 = torch.as_tensor(_gauss_band(x.shape[2], float(sxy)),
                         device=x.device)
    if ref_round:
        b0, b1, x = bf16_round(b0), bf16_round(b1), bf16_round(x)
    xd = x
    if dtype is not None:
        b0, b1, xd = b0.to(dtype), b1.to(dtype), x.to(dtype)
    t1 = torch.einsum('hk,bkwc->bhwc', b0, xd)
    return torch.einsum('wk,bhkc->bhwc', b1, t1).to(x.dtype)


def _grid_shape(hw: Tuple[int, int], sxy: float, srgb: float,
                vrange: float = 255.0) -> Tuple[int, ...]:
    """Dims of the scatter grid: spatial with 1+2 margin cells, colour
    with 2+2.  The colour margins let the colour-axis blurs run as shifts
    of one flattened (gr, gg, gb, C) dim: the bleed across rows lands
    only in margin cells, which are never splatted into nor sliced
    from."""
    gy = int(np.floor((hw[0] - 1) / sxy)) + 3
    gx = int(np.floor((hw[1] - 1) / sxy)) + 3
    gc = int(np.floor(vrange / srgb)) + 5
    return (gy, gx, gc, gc, gc)


def bilateral_structure(hw: Tuple[int, int], sxy: float, srgb: float
                        ) -> str:
    """'dense', 'direct' or 'grid': the structure ``make_bilateral``
    builds for an image of hw pixels.  The exact dense kernel for at most
    10 240 pixels; the direct window when its offsets are few (radius
    <= 8 or at most 3200 offsets) or the scatter grid's colour cube would
    explode (ADP's srgb 4: 68^3 colour cells per spatial cell); else the
    scatter grid."""
    if hw[0] * hw[1] <= 10240:
        return 'dense'
    r = int(np.ceil(3.0 * sxy))
    n_offsets = np.pi * (3.0 * sxy) ** 2
    grid_cells = int(np.prod(_grid_shape(hw, sxy, srgb)))
    if r <= 8 or n_offsets <= 3200 or grid_cells > 80_000_000:
        return 'direct'
    return 'grid'


def _routes_to_grid(hw: Tuple[int, int], sxy: float, srgb: float) -> bool:
    """True iff ``make_bilateral`` picks the scatter grid (the only
    structure the MXU-layout grid replaces)."""
    return bilateral_structure(hw, sxy, srgb) == 'grid'


def _batched(x: torch.Tensor):
    """(x with a batch dim, whether one was added)."""
    return (x[None], True) if x.ndim == 3 else (x, False)


def gaussian_message(Q: torch.Tensor, sxy: float,
                     exclude_self: bool = True) -> torch.Tensor:
    """Symmetric-normalized spatial Gaussian message of Q [H,W,C] or
    [B,H,W,C]."""
    q, squeeze = _batched(Q)
    ones = torch.ones(q.shape[:3] + (1,), dtype=q.dtype, device=q.device)
    n = torch.rsqrt(torch.clamp(_gaussian_filter_raw(ones, sxy), min=1e-20))
    out = n * _gaussian_filter_raw(n * q, sxy)
    if exclude_self:
        out = out - (n * n) * q
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# Bilateral structures
# ---------------------------------------------------------------------------

class BilateralGrid:
    """Scatter bilateral grid on guide images [B,H,W,3] (or one [H,W,3];
    ``filter`` then takes [H,W,C]): splat indices and weights computed
    once per guide and reused across mean-field iterations.

    mode='fast': one scatter + 4 gathers per filter (nearest splat,
    spatial-bilinear x colour-nearest slice).  'nearest': nearest splat +
    32-corner slice.  'multilinear': 32-corner splat + slice.

    The grid of a batch is one array [B * cells, C]: image b's cells
    start at row b * cells.  f32 throughout.  The reference scatters
    into a bf16 grid and computes in f32 from the first blur pass on;
    ref_round=True does the same: the filter input is rounded to bf16;
    the nearest splat then adds pixel after pixel in bf16, every add
    rounding, in pixel order (XLA's scatter on the CPU); the 32-corner
    splat sums its f32 updates in f32 and rounds the finished grid (XLA
    widens that scatter); nothing after the scatter is rounded."""

    def __init__(self, imgs: torch.Tensor, sxy: float, srgb: float,
                 mode: str = 'fast', ref_round: bool = False):
        if mode not in _GRID_BLUR_SIGMA:
            raise ValueError(f'unknown grid mode {mode!r}')
        imgs, self._squeeze = _batched(imgs.to(torch.float32))
        b, h, w = imgs.shape[:3]
        dev = imgs.device
        self.bhw = (b, h, w)
        self.mode = mode
        self.ref_round = ref_round
        self.gshape = _grid_shape((h, w), sxy, srgb)
        self.nflat = int(np.prod(self.gshape))
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev), indexing='ij')
        # spatial offset +1 (one margin cell for the upper corner); colour
        # offset +2 (two margin cells on both sides, see _grid_shape)
        coords = [(yy / sxy + 1.0).expand(b, h, w),
                  (xx / sxy + 1.0).expand(b, h, w),
                  imgs[..., 0] / srgb + 2.0,
                  imgs[..., 1] / srgb + 2.0,
                  imgs[..., 2] / srgb + 2.0]
        coords = [f.reshape(b, h * w) for f in coords]
        lo = [torch.floor(f).long() for f in coords]
        frac = [f - torch.floor(f) for f in coords]
        strides = [int(v) for v in
                   np.cumprod((1,) + self.gshape[:0:-1])[::-1]]
        base = (torch.arange(b, device=dev) * self.nflat).view(b, 1)
        near = [torch.round(f).long() for f in coords]
        if mode == 'fast':
            fixed = base + sum(near[d] * strides[d] for d in range(2, 5))
            corners, dims = 4, 2
        else:
            fixed, corners, dims = base, 32, 5
        idx, wgt = [], []
        for corner in range(corners):
            widx = fixed
            wg = torch.ones((b, h * w), dtype=torch.float32, device=dev)
            for d in range(dims):
                bit = (corner >> d) & 1
                widx = widx + (lo[d] + bit) * strides[d]
                wg = wg * (frac[d] if bit else (1.0 - frac[d]))
            idx.append(widx.reshape(-1))
            wgt.append(wg.reshape(-1))
        self.idx = torch.stack(idx)        # [n_corners, B*N] int64
        self.wgt = torch.stack(wgt)        # [n_corners, B*N] f32
        if mode in ('nearest', 'fast'):
            self.nearest_idx = (base + sum(
                near[d] * strides[d] for d in range(5))).reshape(-1)
            if ref_round:
                # rounds of the sequential bf16 scatter: round k adds the
                # k-th pixel (in pixel order) of every cell
                order = torch.argsort(self.nearest_idx, stable=True)
                cells = self.nearest_idx[order]
                pos = torch.arange(cells.numel(), device=dev)
                first = torch.ones_like(cells, dtype=torch.bool)
                first[1:] = cells[1:] != cells[:-1]
                rank = pos - torch.cummax(
                    torch.where(first, pos, torch.zeros_like(pos)), 0)[0]
                self._rounds = [order[rank == k]
                                for k in range(int(rank.max()) + 1)]
        self.blur_ks = [_blur_kernel1d(s, _GRID_BLUR_RADIUS)
                        for s in _GRID_BLUR_SIGMA[mode]]

    def color_passes(self, c: int):
        """The three colour-axis passes (taps, stride) of a C-channel
        grid's flat (gr, gg, gb, C) stripe, in blur order gr, gg, gb."""
        _, _, _, gg, gb = self.gshape
        return [(self.blur_ks[2], gg * gb * c), (self.blur_ks[3], gb * c),
                (self.blur_ks[4], c)]

    def splat(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,H,W,C] -> the grid [B, gy, gx, gr*gg*gb*C] f32 before any
        blur."""
        b, h, w = self.bhw
        c = x.shape[-1]
        vals = x.to(torch.float32).reshape(-1, c)
        if self.ref_round:
            vals = bf16_round(vals)
        grid = torch.zeros((b * self.nflat, c), dtype=torch.float32,
                           device=x.device)
        if self.mode == 'multilinear':
            grid.index_add_(0, self.idx.reshape(-1),
                            (self.wgt[..., None] * vals[None]).reshape(-1, c))
            if self.ref_round:
                grid = bf16_round(grid)
        elif self.ref_round:
            for sel in self._rounds:
                rows = self.nearest_idx[sel]
                grid[rows] = bf16_round(grid[rows] + vals[sel])
        else:
            grid.index_add_(0, self.nearest_idx, vals)
        gy, gx = self.gshape[:2]
        return grid.view(b, gy, gx, -1)

    def filter(self, x: torch.Tensor) -> torch.Tensor:
        """Approximate K @ x per image; x [B,H,W,C] (or [H,W,C] for a
        single guide).  The colour blur is the ``flat_color_blur`` kernel
        on whole-F stripes (its plain version on the CPU)."""
        if self._squeeze:
            x = x[None]
        b, h, w = self.bhw
        if tuple(x.shape[:3]) != self.bhw:
            raise ValueError(f'filter input {tuple(x.shape)} does not '
                             f'match the guide {self.bhw}')
        c = x.shape[-1]
        gy, gx = self.gshape[:2]
        g = self.splat(x)
        g = _sep_conv(g, self.blur_ks[0], 1)
        g = _sep_conv(g, self.blur_ks[1], 2)
        g = K.flat_color_blur(g.view(b * gy * gx, -1), self.color_passes(c))
        gflat = g.view(b * self.nflat, c)
        # corner loop: peak memory stays at [B*N, C] per step
        out = torch.zeros((b * h * w, c), dtype=torch.float32,
                          device=x.device)
        for i in range(self.idx.shape[0]):
            out = out + self.wgt[i][:, None] * gflat[self.idx[i]]
        out = out.view(b, h, w, c)
        return out[0] if self._squeeze else out


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift [..., H, W, C] by (dy, dx) with zero fill:
    out[p] = x[p + (dy, dx)]."""
    h, w = x.shape[-3:-1]
    ay, ax = abs(dy), abs(dx)
    padded = torch.nn.functional.pad(x, (0, 0, ax, ax, ay, ay))
    return padded[..., ay + dy:ay + dy + h, ax + dx:ax + dx + w, :]


class DirectBilateral:
    """Exact truncated windowed bilateral filter for small spatial sigmas
    (the VOC M7 HistoSegNet config's sxy = 80/48) and for colour cubes no
    grid can hold (ADP's srgb 4), on guide images [B,H,W,3] or one
    [H,W,3].  Truncated at radius ceil(3*sxy), offsets in the circle.

    ``filter`` computes the per-offset colour weight maps anew at every
    call, a row of offsets at a time.  The reference keeps them between
    calls while they fit 256 MB an image; on the card reading kept maps
    back costs more than computing them (measured on an H100: PERF.md),
    so the port has the one path."""

    def __init__(self, imgs: torch.Tensor, sxy: float, srgb: float):
        self.r = int(np.ceil(3.0 * sxy))
        offs, wspace = [], []
        for dy in range(-self.r, self.r + 1):
            for dx in range(-self.r, self.r + 1):
                d2 = dy * dy + dx * dx
                if d2 > (3.0 * sxy) ** 2:
                    continue
                offs.append((dy, dx))
                wspace.append(float(np.exp(-0.5 * d2 / (sxy * sxy))))
        self.offs = offs
        self.wspace = wspace
        self.img, self._squeeze = _batched(imgs.to(torch.float32))
        self.srgb = srgb

    def filter(self, x: torch.Tensor) -> torch.Tensor:
        if self._squeeze:
            return self._filter(x[None])[0]
        return self._filter(x)

    def _filter(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,H,W,C] -> K @ x per image."""
        # The reference's scan visits the offsets one by one, computing
        # each colour weight map.  Here the weight maps of a whole row
        # of offsets (one dy, a run of dx) are computed at once
        # from strided views of the padded image (`unfold`); then the
        # row's offsets join the total one by one, in the reference's
        # order, each as one fused multiply-add over [B,H,W,C].  Outside
        # the image the padded x is zero, which stands for the
        # reference's validity mask.
        b, h, w, c = x.shape
        r = self.r
        img_p = torch.nn.functional.pad(self.img, (0, 0, r, r, r, r))
        x_p = torch.nn.functional.pad(x, (0, 0, r, r, r, r))
        img_t = self.img.permute(0, 1, 3, 2)[:, :, None]     # [B,H,1,3,W]
        inv2s2 = 0.5 / (self.srgb * self.srgb)
        ws_all = torch.tensor(self.wspace, dtype=torch.float32,
                              device=x.device)
        acc = torch.zeros_like(x)
        i0 = 0
        while i0 < len(self.offs):
            dy, dx0 = self.offs[i0]
            i1 = i0
            while i1 < len(self.offs) and self.offs[i1][0] == dy:
                i1 += 1
            rows = slice(r + dy, r + dy + h)
            # [B,H,K,3,W]: the image shifted by each of the row's K offsets
            win_i = img_p[:, rows].unfold(2, w, 1)[:, :, r + dx0:
                                                   r + dx0 + (i1 - i0)]
            dI2 = torch.sum((img_t - win_i) ** 2, dim=3)     # [B,H,K,W]
            wm = ws_all[i0:i1].view(1, 1, -1, 1) * torch.exp(-dI2 * inv2s2)
            for k in range(i1 - i0):
                c0 = r + dx0 + k
                acc.addcmul_(wm[:, :, k, :, None], x_p[:, rows, c0:c0 + w])
            i0 = i1
        return acc


class DenseBilateral:
    """Exact bilateral filter through the materialized [N, N] kernel, for
    small pixel counts (the 41x41 seed-grid CRF inside SEC/DSRG training:
    11 MB an image and one matrix product a filter), on guide images
    [B,H,W,3] or one [H,W,3]."""

    def __init__(self, imgs: torch.Tensor, sxy: float, srgb: float):
        imgs, self._squeeze = _batched(imgs.to(torch.float32))
        b, h, w = imgs.shape[:3]
        self.bhw = (b, h, w)
        dev = imgs.device
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev), indexing='ij')
        pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], 1)
        d2 = torch.sum((pos[:, None] - pos[None]) ** 2, -1)
        rgb = imgs.reshape(b, h * w, 3)
        c2 = sum((rgb[:, :, None, ch] - rgb[:, None, :, ch]) ** 2
                 for ch in range(3))
        self.K = torch.exp(-0.5 * d2 / (sxy * sxy)
                           - 0.5 * c2 / (srgb * srgb))       # [B,N,N]

    def filter(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w = self.bhw
        if self._squeeze:
            x = x[None]
        out = torch.matmul(self.K, x.reshape(b, h * w, -1)).view(
            b, h, w, -1)
        return out[0] if self._squeeze else out


def make_bilateral(imgs: torch.Tensor, sxy: float, srgb: float,
                   grid_mode: str = 'fast', ref_round: bool = False):
    """The bilateral structure for these guide images ([B,H,W,3] or
    [H,W,3]), by ``bilateral_structure``.  grid_mode: the scatter grid's
    fidelity/speed trade-off ('multilinear' | 'nearest' | 'fast')."""
    hw = tuple(imgs.shape[-3:-1])
    kind = bilateral_structure(hw, sxy, srgb)
    if kind == 'dense':
        return DenseBilateral(imgs, sxy, srgb)
    if kind == 'direct':
        if np.pi * (3.0 * sxy) ** 2 > 40_000:
            raise ValueError(
                f'bilateral config sxy={sxy} srgb={srgb} on {hw} is '
                'intractable for both window and grid structures')
        return DirectBilateral(imgs, sxy, srgb)
    return BilateralGrid(imgs, sxy, srgb, mode=grid_mode,
                         ref_round=ref_round)


def _bilateral_filter_raw(x: torch.Tensor, img: torch.Tensor, sxy: float,
                          srgb: float) -> torch.Tensor:
    return make_bilateral(img, sxy, srgb).filter(x)


def bilateral_message(Q: torch.Tensor, img: torch.Tensor, sxy: float,
                      srgb: float, exclude_self: bool = True
                      ) -> torch.Tensor:
    """Symmetric-normalized bilateral message of Q [H,W,C] or [B,H,W,C]
    on the structure ``make_bilateral`` picks."""
    filt = make_bilateral(img, sxy, srgb)
    ones = torch.ones(Q.shape[:-1] + (1,), dtype=Q.dtype, device=Q.device)
    n = torch.rsqrt(torch.clamp(filt.filter(ones), min=1e-20))
    out = n * filt.filter(n * Q)
    if exclude_self:
        out = out - (n * n) * Q     # the kernel's self weight is 1
    return out


def _fine_color_native_ok(hw: Tuple[int, int], config) -> bool:
    """Whether a grid-routed config on CPU tensors goes to the native
    permutohedral lattice: fine-colour configs (the IRNet label CRF's
    srgb 5) build scatter grids of more than 5 M cells, which the
    reference hands to its C++ library where that loads.  The library
    is loaded if it is built, never built here."""
    if _NATIVE_DISABLED:
        return False
    cells = int(np.prod(_grid_shape(hw, config.bi_sxy, config.bi_srgb)))
    return cells > 5_000_000 and _native.available()


def _mxu_ok(hw: Tuple[int, int], n_ch: int, config) -> bool:
    """Whether the config takes the grid path — the reference's TPU
    routing: grid-routed and applicable with 8-aligned cells, unless
    WSSS_TPU_NO_MXU is set."""
    if _MXU_DISABLED or not config.bi_compat:
        return False
    if not _routes_to_grid(hw, config.bi_sxy, config.bi_srgb):
        return False
    return _mxu.applicable(config.bi_sxy, config.bi_srgb, n_ch,
                           MXU_CELL_MULT, require8=True)


def _mean_field_mxu(probs: torch.Tensor, imgs: torch.Tensor, *, g_sxy,
                    g_compat, bi_sxy, bi_srgb, bi_compat, iterations,
                    exclude_self=True, ref_round=False,
                    state_bf16=False,
                    cell_mult=MXU_CELL_MULT) -> torch.Tensor:
    """Batched mean field over the bilateral grid.

    The reference splits a batch into chunks to bound the TPU's working
    set: 2 images where the grid's v2 kernels run, 1 where its v1
    kernels do (``_mxu_chunk``, meanfield.py:737-743).  That changes no
    math, so the port runs the whole batch at once on either route (the
    C=21 grid of a VOC batch of 8 at 321^2 is 223 MB of f32, the v1
    route's per-tile partials 704 MB).  Which route the two grids take
    (``mxu_grid.MXUBilateralGrid``: v2, or v1 for more than 32 classes
    or under WSSS_TPU_MXU_V1) is theirs to choose; the C=1 normalizer
    grid follows the message grid through ``share_from``.

    ref_round=True rounds to bf16 where the reference does (filter input
    and output, grid kernels, Gaussian-message operands) — a CPU-test
    switch only.  cell_mult: the colour cell in units of srgb (the
    row-banded ``mxu_sharded`` path and its tests use 1).

    state_bf16 (``mean_field`` passes ``_CRF_STATE_BF16`` on a CUDA
    device only; elsewhere the state stays float32, as in the reference's
    interpret mode, while a direct call runs it on any device): after
    the float32 normalizers, U, Q and the normalizers drop to bf16 and
    the loop runs in bf16 as the reference's does (meanfield.py:602-630).  The grid kernels keep
    their float32 inputs and outputs: the filter's bf16 input is cast up
    exactly and its output rounds to bf16, where the reference's filter
    returns its input's dtype.  Returns float32."""
    c = probs.shape[-1]
    h, w = probs.shape[-3:-1]
    imgs = imgs.to(torch.float32)
    U = -torch.log(torch.clamp(probs.to(torch.float32), min=1e-10))
    logits0 = -U - torch.amax(-U, dim=-1, keepdim=True)
    Q = torch.softmax(logits0, dim=-1)

    use_ds = (not _MXU_DS_DISABLED and bi_sxy >= MXU_DS_MIN_SXY
              and min(h, w) >= 2 * bi_sxy)
    if use_ds:
        f = bi_sxy / float(MXU_DS_CELL)
        hd, wd = max(int(round(h / f)), 8), max(int(round(w / f)), 8)
        img_g = resize_bilinear(imgs, (hd, wd))
        sxy_g = float(MXU_DS_CELL)
    else:
        img_g, sxy_g, (hd, wd) = imgs, bi_sxy, (h, w)

    grid = _mxu.MXUBilateralGrid(img_g, sxy_g, bi_srgb, c,
                                 cell_mult=cell_mult, ref_round=ref_round)
    grid1 = _mxu.MXUBilateralGrid(img_g, sxy_g, bi_srgb, 1,
                                  cell_mult=cell_mult, share_from=grid,
                                  ref_round=ref_round)
    ones_g = torch.ones(img_g.shape[:3] + (1,), dtype=torch.float32,
                        device=probs.device)
    n_b = torch.rsqrt(torch.clamp(grid1.filter(ones_g), min=1e-20))
    # the upsampled normalizer only feeds the self-exclusion term
    n_b_up = resize_bilinear(n_b, (h, w)) if use_ds else n_b
    if g_compat:
        ones = torch.ones(Q.shape[:3] + (1,), dtype=torch.float32,
                          device=probs.device)
        n_g = torch.rsqrt(torch.clamp(_gaussian_filter_raw(ones, g_sxy),
                                      min=1e-20))
    msg_dtype = None
    if state_bf16:
        msg_dtype = torch.bfloat16
        U, Q, n_b, n_b_up = (t.to(msg_dtype) for t in (U, Q, n_b, n_b_up))
        if g_compat:
            n_g = n_g.to(msg_dtype)

    def bilateral(v):
        if ref_round:
            return bf16_round(grid.filter(bf16_round(v)))  # :625, :1148
        if v.dtype != torch.float32:
            return grid.filter(v.to(torch.float32)).to(v.dtype)
        return grid.filter(v)

    for _ in range(iterations):
        msg = 0.
        if g_compat:
            m = n_g * _gaussian_filter_raw(n_g * Q, g_sxy,
                                           ref_round=ref_round,
                                           dtype=msg_dtype)
            if exclude_self:
                m = m - (n_g * n_g) * Q
            msg = msg + g_compat * m
        if use_ds:
            q_d = resize_bilinear(Q, (hd, wd))
            m = resize_bilinear(n_b * bilateral(n_b * q_d), (h, w))
        else:
            m = n_b * bilateral(n_b * Q)
        if exclude_self:
            m = m - (n_b_up * n_b_up) * Q
        msg = msg + bi_compat * m
        Q = torch.softmax(-U + msg, dim=-1)
    return Q.to(torch.float32)


def _mean_field_single(probs: torch.Tensor, imgs: torch.Tensor, *, g_sxy,
                       g_compat, bi_sxy, bi_srgb, bi_compat, iterations,
                       exclude_self=True, ref_round=False) -> torch.Tensor:
    """Mean field of a batch [B, H, W, C] on the structure
    ``make_bilateral`` picks, f32 state (the reference runs it per image,
    vmapped or looped)."""
    imgs = imgs.to(torch.float32)
    U = -torch.log(torch.clamp(probs.to(torch.float32), min=1e-10))
    logits0 = -U - torch.amax(-U, dim=-1, keepdim=True)
    Q = torch.softmax(logits0, dim=-1)

    # loop-invariant: splat geometry and the symmetric normalizers
    ones = torch.ones(Q.shape[:3] + (1,), dtype=torch.float32,
                      device=Q.device)
    if bi_compat:
        grid = make_bilateral(imgs, bi_sxy, bi_srgb, ref_round=ref_round)
        n_b = torch.rsqrt(torch.clamp(grid.filter(ones), min=1e-20))
    if g_compat:
        n_g = torch.rsqrt(torch.clamp(_gaussian_filter_raw(ones, g_sxy),
                                      min=1e-20))
    for _ in range(iterations):
        msg = 0.
        if g_compat:
            m = n_g * _gaussian_filter_raw(n_g * Q, g_sxy)
            if exclude_self:
                m = m - (n_g * n_g) * Q
            msg = msg + g_compat * m
        if bi_compat:
            m = n_b * grid.filter(n_b * Q)
            if exclude_self:
                m = m - (n_b * n_b) * Q
            msg = msg + bi_compat * m
        Q = torch.softmax(-U + msg, dim=-1)
    return Q


# largest live buffer of one `_mean_field_single` call; a batch is cut
# into chunks under it (the reference chunks for its HBM the same way)
_SINGLE_CHUNK_BYTES = 2 * 1024 ** 3


def _single_chunk(b: int, hw: Tuple[int, int], c: int, config) -> int:
    """Images per `_mean_field_single` call."""
    n = hw[0] * hw[1]
    per_img = n * c * 4
    if config.bi_compat:
        kind = bilateral_structure(hw, config.bi_sxy, config.bi_srgb)
        if kind == 'dense':
            per_img = max(per_img, n * n * 4)
        elif kind == 'grid':        # the grid and two blur buffers
            cells = int(np.prod(_grid_shape(hw, config.bi_sxy,
                                            config.bi_srgb)))
            per_img = max(per_img, 3 * cells * c * 4)
    return max(1, min(b, _SINGLE_CHUNK_BYTES // per_img))


def mean_field(probs: torch.Tensor, img: torch.Tensor, config,
               exclude_self: bool = True, ref_round: bool = False
               ) -> torch.Tensor:
    """Dense-CRF mean field.  probs/img: [H,W,C]/[H,W,3] or batched
    [B,...], on one device.  probs are pydensecrf's unary_from_softmax
    input (U = -log p); a class the caller masked to ~0 probability
    stays at ~0 posterior.  Returns the posterior Q, shaped like probs.

    Routes as the reference does: the MXU-layout grid where `_mxu_ok`,
    else the structure of ``make_bilateral``; a fine-colour scatter grid
    goes to the native permutohedral lattice where that library is built
    and the tensors lie on the CPU.  Tensors on the card stay there: the
    scatter grid runs with the ``flat_color_blur`` kernel."""
    if probs.ndim == 3:
        return mean_field(probs[None], img[None], config,
                          exclude_self=exclude_self, ref_round=ref_round)[0]
    b, h, w, c = probs.shape
    hw = (h, w)
    kw = dict(g_sxy=config.g_sxy, g_compat=config.g_compat,
              bi_sxy=config.bi_sxy, bi_srgb=config.bi_srgb,
              bi_compat=config.bi_compat, iterations=config.iterations,
              exclude_self=exclude_self, ref_round=ref_round)
    mxu = _mxu_ok(hw, c, config)
    if (probs.device.type == 'cpu' and img.device.type == 'cpu'
            and config.bi_compat and not mxu
            and _routes_to_grid(hw, config.bi_sxy, config.bi_srgb)
            and _fine_color_native_ok(hw, config)):
        p_np = probs.detach().to(torch.float32).numpy()
        i_np = img.detach().to(torch.float32).numpy()
        return torch.from_numpy(np.stack([_native.mean_field_native(
            p_np[i], i_np[i], config, exclude_self=exclude_self)
            for i in range(b)]))
    if mxu:
        return _mean_field_mxu(probs, img, **kw,
                               state_bf16=(_CRF_STATE_BF16 and
                                           probs.device.type == 'cuda'))
    chunk = _single_chunk(b, hw, c, config)
    if chunk >= b:
        return _mean_field_single(probs, img, **kw)
    return torch.cat([_mean_field_single(probs[s:s + chunk],
                                         img[s:s + chunk], **kw)
                      for s in range(0, b, chunk)])


def crf_label_refine(img: torch.Tensor, labels: torch.Tensor, n_labels: int,
                     config, gt_prob: float = 0.7,
                     exclude_self: bool = True) -> torch.Tensor:
    """Hard-label CRF refinement (IRNet's ir-label step): unary from a
    label map with confidence gt_prob, mean field, argmax back to labels.

    img: [H,W,3] 0..255; labels: [H,W] int, or both batched.  Returns
    int32 labels shaped like `labels`."""
    onehot = torch.nn.functional.one_hot(labels.long(), n_labels).to(
        torch.float32)
    probs = onehot * gt_prob + (1.0 - onehot) * (1.0 - gt_prob) / max(
        n_labels - 1, 1)
    q = mean_field(probs, img, config, exclude_self=exclude_self)
    return torch.argmax(q, dim=-1).to(torch.int32)
