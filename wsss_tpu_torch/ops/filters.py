"""Image resampling and the Gaussian blur of the port (counterpart of
``wsss_tpu/ops/filters.py`` ``resize_bilinear`` / ``resize_nearest`` /
``gaussian_blur``).

The reference resizes with ``jax.image.resize``: half-pixel centres, and
an antialiasing triangle kernel widened by the scale when downsampling.
``F.interpolate(mode='bilinear', align_corners=False)`` computes the same
function: with ``antialias=True`` when an axis shrinks (torch's
antialiased path widens its kernel per axis exactly as jax does, and
reduces to plain bilinear on an axis that grows), and without it when
both grow.  ``mode='nearest-exact'`` is jax's half-pixel nearest.
Layout is the JAX package's: channels last.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _nhwc_resize(x: torch.Tensor, out_hw: Tuple[int, int],
                 mode: str) -> torch.Tensor:
    """Resize the two spatial axes of [..., H, W, C]."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    xc = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    if mode == 'bilinear':
        y = F.interpolate(xc, size=(oh, ow), mode='bilinear',
                          align_corners=False,
                          antialias=(oh < h or ow < w))
    else:
        y = F.interpolate(xc, size=(oh, ow), mode='nearest-exact')
    return y.permute(0, 2, 3, 1).reshape(lead + (oh, ow, c))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] (``jax.image.resize`` bilinear)."""
    return _nhwc_resize(x, out_hw, 'bilinear')


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """Nearest resize of [..., H, W, C] (``jax.image.resize`` nearest)."""
    return _nhwc_resize(x, out_hw, 'nearest')


def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage's kernel (radius = int(truncate*sigma + 0.5))."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur over the last two axes of [..., H, W],
    edge-mirrored with the edge sample repeated: scipy's 'reflect', which
    numpy and jax call 'symmetric' (scipy.ndimage.gaussian_filter's
    default)."""
    k = torch.as_tensor(_gaussian_kernel1d(sigma, truncate),
                        device=img.device)
    r = (k.shape[0] - 1) // 2
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = img.reshape((-1, 1, h, w)).to(torch.float32)

    def mirror(n):
        """Source index of each padded position along an axis of n."""
        i = torch.arange(-r, n + r, device=img.device) % (2 * n)
        return torch.where(i < n, i, 2 * n - 1 - i)

    x = x[:, :, mirror(h)][:, :, :, mirror(w)]
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    return x.reshape(lead + (h, w))
