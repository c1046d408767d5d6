"""Colour-axis blur of the scatter bilateral grid, per spatial cell
(counterpart of ``wsss_tpu/ops/crf/pallas_blur.py``; the file keeps the
reference's name, the kernel behind it is CUDA).

The reference keeps a spatial cell's flat (gr, gg, gb, C) stripe in the
TPU's VMEM and applies the colour-axis convolutions to it: all three when
the stripe fits (``color_blur_fused``), else the (gg, gb) pair on per-gr
stripes followed by a flat gr pass (``blur_color_axes``).  Both are
chains of one pass, which the ``flat_color_blur`` kernel computes on the
card and its plain version (the ``_flat_conv_last`` chain) on the CPU.

The two forms differ in margin cells only: a per-gr stripe's ends are
zero-filled where the flat form bleeds across gr rows, and the scatter
grid never splats into nor slices from its two margin cells per colour
axis.  ``BilateralGrid.filter`` runs the fused form whatever F is.

``blur_color_axes`` is a study function, as in the reference: no entry
point of the port calls it.  It keeps the reference's stripe limit as its
dispatch so that the split form stays reproducible and checked against
the fused one; nothing on Hopper needs the limit.
"""
from __future__ import annotations

import torch

from wsss_tpu_torch.kernels import bilateral as K

# stripe bytes beyond which the reference's kernel overflows VMEM
VMEM_STRIPE_LIMIT = 384 * 1024


def fits_vmem(f_elems: int, dtype_bytes: int = 4) -> bool:
    return f_elems * dtype_bytes <= VMEM_STRIPE_LIMIT


def color_blur_fused(grid: torch.Tensor, ks, strides) -> torch.Tensor:
    """The gr/gg/gb convolutions of every spatial cell's whole stripe.

    grid: [gy, gx, F] f32 with F = gr*gg*gb*C; ks: three 1-D kernels;
    strides: element strides of (gr, gg, gb) within F."""
    gy, gx, f = grid.shape
    passes = [(k, int(s)) for k, s in zip(ks, strides)]
    return K.flat_color_blur(grid.reshape(gy * gx, f), passes).view(
        gy, gx, f)


def blur_color_axes(grid: torch.Tensor, ks, strides, gshape
                    ) -> torch.Tensor:
    """The reference's dispatch: the fused form when a cell's stripe is
    at most VMEM_STRIPE_LIMIT bytes; else the (gg, gb) passes on per-gr
    stripes and the gr pass on whole stripes; ValueError when even a
    per-gr stripe is over the limit.

    grid: [gy, gx, F]; ks: (k_r, k_g, k_b); strides: element strides of
    (gr, gg, gb); gshape: the 5-D grid shape."""
    gy, gx, f = grid.shape
    if fits_vmem(f):
        return color_blur_fused(grid, ks, strides)
    gr = gshape[2]
    stripe = f // gr
    if not fits_vmem(stripe):
        raise ValueError('color stripe too large even per-gr '
                         f'({stripe} elems); use the full-F form')
    out = K.flat_color_blur(
        grid.reshape(gy * gx * gr, stripe),
        [(ks[1], int(strides[1])), (ks[2], int(strides[2]))])
    return K.flat_color_blur(out.view(gy * gx, f),
                             [(ks[0], int(strides[0]))]).view(gy, gx, f)
