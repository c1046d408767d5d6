"""Weak-cue assembly of the port (counterpart of ``wsss_tpu/ops/cues.py``):
so far ``modify_by_htt`` only, the ADP background / other-tissue
synthesis that HistoSegNet's ADP path needs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from wsss_tpu_torch.ops.filters import gaussian_blur, resize_bilinear


def modify_by_htt(gradcam: torch.Tensor, images: torch.Tensor,
                  exception_inds: Sequence[int],
                  bg_ind: int = 0,
                  other_ind: Optional[int] = None,
                  adipose_cam: Optional[torch.Tensor] = None,
                  background_max: float = 0.75,
                  other_tissue_mult: float = 0.05,
                  relu_bg: bool = False) -> torch.Tensor:
    """Synthesize the Background (and Other) channels for ADP
    (02_cues/adp_cues.py:244-302, 03c_hsn/utilities.py:306-364).

    gradcam: [B,h,w,C] with the bg (/other) channels present but unset.
    images: [B,H,W,3] unnormalized RGB (0..255) at classifier input size.
    exception_inds: channels whose activation is subtracted from the
        synthetic background (adipose for morph, G.O/G.N/T for func).
    adipose_cam: [B,h,w] max adipose activation (func only).
    relu_bg: clamp the background at 0 (the reference's 03b variant).

    bg = background_max * sigmoid(4*(mean(img) - 240)), Gaussian sigma 2,
    resized to the CAM grid, minus the max exception activation.
    other = max(other_tissue_mult * (1 - max_c cam), adipose_cam).
    Returns a new tensor."""
    h, w = gradcam.shape[1:3]
    mean_img = torch.mean(images.to(torch.float32), dim=-1)     # [B,H,W]
    bg = background_max * torch.sigmoid(4.0 * (mean_img - 240.0))
    bg = gaussian_blur(bg, sigma=2.0)
    if tuple(bg.shape[1:]) != (h, w):
        bg = resize_bilinear(bg[..., None], (h, w))[..., 0]
    exc = torch.amax(gradcam[..., list(exception_inds)], dim=-1)
    bg = bg - exc
    if relu_bg:
        bg = torch.relu(bg)
    out = gradcam.clone()
    out[..., bg_ind] = bg
    if other_ind is not None:
        other = other_tissue_mult * (1.0 - torch.amax(out, dim=-1))
        if adipose_cam is not None:
            other = torch.maximum(other, adipose_cam)
        out[..., other_ind] = other
    return out
