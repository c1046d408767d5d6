"""Weak-cue assembly of the port (counterpart of ``wsss_tpu/ops/cues.py``):
thresholding, overlap resolution, the VOC background cues, the ADP
background / other-tissue synthesis.  The reference's sparse pickle
packing (``cues_to_sparse`` / ``sparse_to_cues``) is
``io/artifacts.pack_cues`` / ``unpack_cues`` here, the one owner of that
format.

Batched [B, H, W, C] channel-last tensors on one device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from wsss_tpu_torch.ops.filters import gaussian_blur, median3, resize_bilinear


def resolve_overlap(localization: torch.Tensor) -> torch.Tensor:
    """Largest-mask-first overlap resolution (02_cues/utilities.py:221-229).

    localization: bool [B,H,W,C] per-class candidate masks.  Classes are
    taken from the largest to the smallest pixel count, ties in class
    order (a stable sort: most classes tie at 0); each class overwrites
    the pixels before it, so a contested pixel ends with the covering
    class taken last.  Here that is computed at once: each pixel's owner
    is its covering class of highest rank.  Returns the disjoint one-hot
    bool [B,H,W,C]."""
    c = localization.shape[-1]
    loc = localization.to(torch.bool)
    counts = loc.sum(dim=(1, 2))                                # [B,C]
    order = torch.argsort(-counts, dim=1, stable=True)          # [B,C]
    rank = torch.argsort(order, dim=1)          # each class's turn
    score = torch.where(loc, rank[:, None, None, :], -1)
    best, owner = torch.max(score, dim=-1)
    onehot = torch.nn.functional.one_hot(owner, c).to(torch.bool)
    return onehot & (best >= 0)[..., None]


def threshold_cams(cams: torch.Tensor, thresh: float,
                   per_image_max: bool = False) -> torch.Tensor:
    """Candidate masks: cam > thresh * max(cam).

    per_image_max=False is the reference's VOC / DeepGlobe path
    (02_cues/utilities.py:218,262): the max per class is taken over the
    *whole batch*, a quirk that makes cues depend on the batch's
    composition, kept.  True is the ADP path (adp_cues.py:322-323)."""
    dims = (1, 2) if per_image_max else (0, 1, 2)
    return cams > thresh * torch.amax(cams, dim=dims, keepdim=True)


def bg_cues_lowest_decile(bg_cams: torch.Tensor) -> torch.Tensor:
    """VOC background cues (02_cues/utilities.py:211-215): the bg net's
    CAMs [B,H,W,C_bg] summed over classes, 3x3 median, then the pixels
    strictly below the row's element int(0.1*H*W) in sorted order.
    Returns bool [B,H,W]."""
    g = median3(torch.sum(bg_cams, dim=-1))
    b, h, w = g.shape
    flat = torch.sort(g.reshape(b, -1), dim=1).values
    thr = flat[:, int(0.1 * h * w)]
    return g < thr[:, None, None]


def fg_cues(cams: torch.Tensor, thresh: float,
            per_image_max: bool = False) -> torch.Tensor:
    """get_fg_cues (02_cues/utilities.py:236-278): threshold + overlap.
    Returns one-hot bool [B,H,W,C]."""
    return resolve_overlap(threshold_cams(cams, thresh, per_image_max))


def fgbg_cues(fg_cams: torch.Tensor, bg_cams: torch.Tensor, thresh: float,
              per_image_max: bool = False) -> torch.Tensor:
    """get_fgbg_cues (02_cues/utilities.py:183-234): channel 0 = bg from
    the bg net's lowest decile, channels 1.. = fg.  Returns [B,H,W,C+1]."""
    bg = bg_cues_lowest_decile(bg_cams)
    fg = threshold_cams(fg_cams, thresh, per_image_max)
    return resolve_overlap(torch.cat([bg[..., None], fg], dim=-1))


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

