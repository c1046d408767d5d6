"""The dense CRF's mean field as the configurations state it, in plain
PyTorch, written from the method's description and independent of the
program.

Messages use symmetric normalization: ``n * (K @ (n * Q)) - n^2 Q`` with
``n = 1 / sqrt(K @ 1)`` (the self term removed).  The update is
``Q <- softmax(log p + g_compat * m_g + bi_compat * m_b)``, starting from
``Q = softmax(log p)`` with p clamped at 1e-10.

  * Gaussian kernel ``exp(-|dp|^2 / 2 g_sxy^2)``: exact, one truncated
    band-matrix product an axis (radius ceil(4 sxy), at least 1).
  * Bilateral kernel ``exp(-|dp|^2 / 2 sxy^2 - |dI|^2 / 2 srgb^2)``:
    - exact, the materialized [N, N] matrix, for at most
      ``dense_max_pixels`` pixels (the 41x41 seed grid);
    - else the bilateral grid: where sxy >= ds_min_sxy and the image is at
      least 2 sxy on each side, on a guide resampled to cells of ds_cell
      pixels (sxy becomes ds_cell) and upsampled back bilinearly (the
      normalizer of the self term too); spatial nodes every t pixels
      (t = round(sxy) / k, the least k giving t <= max_tile and t a
      multiple of 8), colour cells of cell_mult * srgb (nearest); splat
      with bilinear spatial weights into the 4 nodes around a pixel,
      blur along each colour axis with radius-2 taps of sigma
      sqrt((srgb / cell)^2 - 1/6) (at least sqrt(0.05)) and over the
      nodes with a Kronecker product of band matrices of sigma
      sqrt(k^2 - 1/3), radius max(2, ceil(3 sigma)), then slice with the
      splat's weights."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.numerics import Numerics


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of [..., H, W, C], antialiased on a
    shrinking axis (``jax.image.resize``'s triangle kernel)."""
    h, w, c = x.shape[-3:]
    oh, ow = int(hw[0]), int(hw[1])
    if (oh, ow) == (h, w):
        return x
    lead = x.shape[:-3]
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                      size=(oh, ow), mode='bilinear', align_corners=False,
                      antialias=(oh < h or ow < w))
    return y.permute(0, 2, 3, 1).reshape(lead + (oh, ow, c))


def _band(n: int, sigma: float, radius: int, device) -> torch.Tensor:
    d = np.arange(n)
    off = np.abs(d[:, None] - d[None, :])
    m = np.where(off <= radius, np.exp(-0.5 * (off / sigma) ** 2), 0.0)
    return torch.as_tensor(m.astype(np.float32), device=device)


def gaussian_filter(num: Numerics, x: torch.Tensor, sxy: float):
    """K @ x over the spatial axes of x [B, H, W, C]."""
    r = max(1, int(math.ceil(4.0 * sxy)))
    by = _band(x.shape[1], sxy, r, x.device)
    bx = _band(x.shape[2], sxy, r, x.device)
    t = num.einsum('hk,bkwc->bhwc', by, x)
    return num.einsum('wk,bhkc->bhwc', bx, t)


class DenseBilateral:
    def __init__(self, imgs: torch.Tensor, sxy: float, srgb: float):
        b, h, w, _ = imgs.shape
        yy, xx = torch.meshgrid(torch.arange(h, device=imgs.device),
                                torch.arange(w, device=imgs.device),
                                indexing='ij')
        pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], 1).float()
        d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
        rgb = imgs.reshape(b, h * w, 3).float()
        c2 = ((rgb[:, :, None] - rgb[:, None]) ** 2).sum(-1)
        self.k = torch.exp(-0.5 * d2 / sxy ** 2 - 0.5 * c2 / srgb ** 2)
        self.bhw = (b, h, w)

    def filter(self, num: Numerics, x: torch.Tensor) -> torch.Tensor:
        b, h, w = self.bhw
        return num.matmul(self.k, x.reshape(b, h * w, -1)).view(
            b, h, w, -1)


class GridBilateral:
    def __init__(self, imgs: torch.Tensor, sxy: float, srgb: float,
                 grid: dict):
        t0 = int(round(sxy))
        if abs(sxy - t0) > 1e-6:
            raise ValueError(f'grid needs an integer sxy, got {sxy}')
        k = next(k for k in range(1, t0 + 1)
                 if t0 % k == 0 and t0 // k <= grid['max_tile']
                 and (t0 // k) % 8 == 0)
        t = t0 // k
        b, h, w, _ = imgs.shape
        dev = imgs.device
        cell = srgb * grid['cell_mult']
        gc = int(round(255.0 / cell)) + 1
        self.gy, self.gx, self.gc, self.t = -(-h // t) + 1, -(-w // t) + 1, \
            gc, t
        self.bhw = (b, h, w)
        idx = torch.clamp(torch.round(imgs.float() / cell), 0, gc - 1).long()
        col = (idx[..., 0] * gc + idx[..., 1]) * gc + idx[..., 2]
        ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)
        fy = (ys % t).float() / t
        fx = (xs % t).float() / t
        wy, wx = (1 - fy, fy), (1 - fx, fx)
        bi = torch.arange(b, device=dev).view(b, 1, 1)
        self.corners = []
        for oy in (0, 1):
            for ox in (0, 1):
                node = ((bi * self.gy + (ys // t + oy).view(1, h, 1))
                        * self.gx + (xs // t + ox).view(1, 1, w))
                self.corners.append(
                    ((node * gc ** 3 + col).reshape(-1),
                     (wy[oy].view(h, 1) * wx[ox].view(1, w))
                     .expand(b, h, w).reshape(-1, 1)))
        sig_col = math.sqrt(max((srgb / cell) ** 2 - 1.0 / 6.0, 0.05))
        rc = grid['blur_radius']
        self.taps = [math.exp(-0.5 * (d / sig_col) ** 2)
                     for d in range(rc + 1)]
        sig_sp = math.sqrt(k * k - 1.0 / 3.0)
        rad = max(2, int(math.ceil(3.0 * sig_sp)))
        self.sp = torch.kron(_band(self.gy, sig_sp, rad, 'cpu').double(),
                             _band(self.gx, sig_sp, rad, 'cpu').double())
        self.sp = self.sp.float().to(dev)

    def filter(self, num: Numerics, x: torch.Tensor) -> torch.Tensor:
        b, h, w = self.bhw
        c = x.shape[-1]
        gc = self.gc
        flat = x.reshape(-1, c)
        g = torch.zeros(b * self.gy * self.gx * gc ** 3, c,
                        dtype=x.dtype, device=x.device)
        for rows, wq in self.corners:
            g.index_add_(0, rows, wq * flat)
        g = g.view(b, self.gy, self.gx, gc, gc, gc, c)
        for dim in (3, 4, 5):
            acc = self.taps[0] * g
            n = g.shape[dim]
            for d in range(1, len(self.taps)):
                if d >= n:
                    break
                lo = g.narrow(dim, 0, n - d)
                hi = g.narrow(dim, d, n - d)
                acc.narrow(dim, d, n - d).add_(lo, alpha=self.taps[d])
                acc.narrow(dim, 0, n - d).add_(hi, alpha=self.taps[d])
            g = acc
        g = num.matmul(self.sp, g.reshape(b, self.gy * self.gx, -1))
        g = g.reshape(-1, c)
        out = 0
        for rows, wq in self.corners:
            out = out + wq * g.index_select(0, rows)
        return out.view(b, h, w, c)


def mean_field(num: Numerics, probs: torch.Tensor, imgs: torch.Tensor,
               crf: dict, grid: dict, dense_max_pixels: int
               ) -> torch.Tensor:
    """The posterior Q [B, H, W, C] of probs [B, H, W, C] on guides
    imgs [B, H, W, 3] (0..255)."""
    b, h, w, c = probs.shape
    imgs = imgs.float()
    logp = torch.log(torch.clamp(probs.float(), min=1e-10))
    q = torch.softmax(logp, dim=-1)
    sxy, srgb = crf['bi_sxy'], crf['bi_srgb']
    ds = (h * w > dense_max_pixels and sxy >= grid['ds_min_sxy']
          and min(h, w) >= 2 * sxy)
    if h * w <= dense_max_pixels:
        bil, hw_g = DenseBilateral(imgs, sxy, srgb), (h, w)
    elif ds:
        f = sxy / float(grid['ds_cell'])
        hw_g = (max(int(round(h / f)), 8), max(int(round(w / f)), 8))
        bil = GridBilateral(resize_bilinear(imgs, hw_g),
                            float(grid['ds_cell']), srgb, grid)
    else:
        bil, hw_g = GridBilateral(imgs, sxy, srgb, grid), (h, w)

    ones_g = torch.ones((b,) + hw_g + (1,), device=probs.device)
    n_b = torch.rsqrt(torch.clamp(bil.filter(num, ones_g), min=1e-20))
    n_b_up = resize_bilinear(n_b, (h, w))
    ones = torch.ones((b, h, w, 1), device=probs.device)
    n_g = torch.rsqrt(torch.clamp(gaussian_filter(num, ones, crf['g_sxy']),
                                  min=1e-20))
    for _ in range(crf['iterations']):
        m_g = n_g * gaussian_filter(num, n_g * q, crf['g_sxy']) \
            - n_g * n_g * q
        m_b = resize_bilinear(n_b * bil.filter(num, n_b * resize_bilinear(
            q, hw_g)), (h, w)) - n_b_up * n_b_up * q
        q = torch.softmax(logp + crf['g_compat'] * m_g
                          + crf['bi_compat'] * m_b, dim=-1)
    return q
