"""Dense-CRF mean-field inference of the port (counterpart of
``wsss_tpu/ops/crf/meanfield.py``).

Only the structure the main path runs is ported: the batched mean field
over the bilateral grid (``_mean_field_mxu``), with the exact spatial
Gaussian message as two band-matrix products.  Both messages use
symmetric normalization, ``n * (K @ (n * Q))`` with ``n = 1/sqrt(K @ 1)``
and the self term ``n^2 Q`` removed; the update is
``Q <- softmax(-U + g_compat * m_g + bi_compat * m_b)``, ``U = -log p``.

Routing follows the reference's compiled TPU path: a config runs here iff
it lands on the bilateral grid and the grid takes it with 8-aligned
spatial cells (``require8=True``).  Every other structure — the dense,
direct-window and scatter-grid bilateral filters and the native
permutohedral route — raises ``NotImplementedError`` until it is ported.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from wsss_tpu_torch.kernels.bilateral import bf16_round
from wsss_tpu_torch.ops.crf import mxu_grid as _mxu
from wsss_tpu_torch.ops.filters import resize_bilinear

# the bilateral message is computed on a guide resampled to MXU_DS_CELL-px
# cells when the spatial kernel is wide (bi_sxy >= MXU_DS_MIN_SXY), and
# upsampled back bilinearly; colour cells are MXU_CELL_MULT * srgb
MXU_DS_CELL = 8
MXU_DS_MIN_SXY = 24
MXU_CELL_MULT = 1.35


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
                         ref_round: bool = False) -> torch.Tensor:
    """K @ x with K = exp(-|dp|^2/2 sxy^2) (self weight 1) over the two
    spatial axes of x [B, H, W, C]: one band-matrix product per axis.
    ref_round rounds the operands to bf16 as the reference's message
    does (meanfield.py:615-616)."""
    b0 = torch.as_tensor(_gauss_band(x.shape[1], float(sxy)),
                         device=x.device)
    b1 = torch.as_tensor(_gauss_band(x.shape[2], float(sxy)),
                         device=x.device)
    if ref_round:
        b0, b1, x = bf16_round(b0), bf16_round(b1), bf16_round(x)
    t1 = torch.einsum('hk,bkwc->bhwc', b0, x)
    return torch.einsum('wk,bhkc->bhwc', b1, t1)


def _grid_shape(hw: Tuple[int, int], sxy: float, srgb: float,
                vrange: float = 255.0) -> Tuple[int, ...]:
    """Dims of the reference's scatter grid (used by its routing)."""
    gy = int(np.floor((hw[0] - 1) / sxy)) + 3
    gx = int(np.floor((hw[1] - 1) / sxy)) + 3
    gc = int(np.floor(vrange / srgb)) + 5
    return (gy, gx, gc, gc, gc)


def _routes_to_grid(hw: Tuple[int, int], sxy: float, srgb: float) -> bool:
    """True iff the reference's make_bilateral picks its bilateral grid
    (the only structure the MXU grid replaces)."""
    n = hw[0] * hw[1]
    if n <= 10240:
        return False
    r = int(np.ceil(3.0 * sxy))
    n_offsets = np.pi * (3.0 * sxy) ** 2
    grid_cells = int(np.prod(_grid_shape(hw, sxy, srgb)))
    return not (r <= 8 or n_offsets <= 3200 or grid_cells > 80_000_000)


def _mxu_ok(hw: Tuple[int, int], n_ch: int, config) -> bool:
    """Whether the config takes the grid path — the reference's TPU
    routing: grid-routed and applicable with 8-aligned cells."""
    if not config.bi_compat:
        return False
    if not _routes_to_grid(hw, config.bi_sxy, config.bi_srgb):
        return False
    return _mxu.applicable(config.bi_sxy, config.bi_srgb, n_ch,
                           MXU_CELL_MULT, require8=True)


def _mean_field_mxu(probs: torch.Tensor, imgs: torch.Tensor, *, g_sxy,
                    g_compat, bi_sxy, bi_srgb, bi_compat, iterations,
                    ref_round=False) -> torch.Tensor:
    """Batched mean field over the bilateral grid, f32 state.

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
    switch only."""
    c = probs.shape[-1]
    h, w = probs.shape[-3:-1]
    imgs = imgs.to(torch.float32)
    U = -torch.log(torch.clamp(probs.to(torch.float32), min=1e-10))
    logits0 = -U - torch.amax(-U, dim=-1, keepdim=True)
    Q = torch.softmax(logits0, dim=-1)

    use_ds = bi_sxy >= MXU_DS_MIN_SXY and min(h, w) >= 2 * bi_sxy
    if use_ds:
        f = bi_sxy / float(MXU_DS_CELL)
        hd, wd = max(int(round(h / f)), 8), max(int(round(w / f)), 8)
        img_g = resize_bilinear(imgs, (hd, wd))
        sxy_g = float(MXU_DS_CELL)
    else:
        img_g, sxy_g, (hd, wd) = imgs, bi_sxy, (h, w)

    grid = _mxu.MXUBilateralGrid(img_g, sxy_g, bi_srgb, c,
                                 cell_mult=MXU_CELL_MULT,
                                 ref_round=ref_round)
    grid1 = _mxu.MXUBilateralGrid(img_g, sxy_g, bi_srgb, 1,
                                  cell_mult=MXU_CELL_MULT, share_from=grid,
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

    def bilateral(v):
        if not ref_round:
            return grid.filter(v)
        return bf16_round(grid.filter(bf16_round(v)))  # :625, :1148

    for _ in range(iterations):
        msg = 0.
        if g_compat:
            m = n_g * _gaussian_filter_raw(n_g * Q, g_sxy,
                                           ref_round=ref_round)
            msg = msg + g_compat * (m - (n_g * n_g) * Q)
        if use_ds:
            q_d = resize_bilinear(Q, (hd, wd))
            m = resize_bilinear(n_b * bilateral(n_b * q_d), (h, w))
        else:
            m = n_b * bilateral(n_b * Q)
        msg = msg + bi_compat * (m - (n_b_up * n_b_up) * Q)
        Q = torch.softmax(-U + msg, dim=-1)
    return Q


def mean_field(probs: torch.Tensor, img: torch.Tensor, config,
               ref_round: bool = False) -> torch.Tensor:
    """Dense-CRF mean field.  probs/img: [H,W,C]/[H,W,3] or batched
    [B,...], on one device.  probs are pydensecrf's unary_from_softmax
    input (U = -log p).  Returns the posterior Q, shaped like probs."""
    hw = tuple(probs.shape[-3:-1])
    if not _mxu_ok(hw, probs.shape[-1], config):
        raise NotImplementedError(
            f'CRF config {config} at {hw} does not route to the bilateral '
            'grid; the dense, direct-window, scatter-grid and native '
            'structures are still to be ported (ROADMAP queue 1 item 8)')
    kw = dict(g_sxy=config.g_sxy, g_compat=config.g_compat,
              bi_sxy=config.bi_sxy, bi_srgb=config.bi_srgb,
              bi_compat=config.bi_compat, iterations=config.iterations,
              ref_round=ref_round)
    if probs.ndim == 3:
        return _mean_field_mxu(probs[None], img[None], **kw)[0]
    return _mean_field_mxu(probs, img, **kw)
