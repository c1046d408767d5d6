"""Grad-CAM of the port (counterpart of ``wsss_tpu/ops/gradcam.py``
``gradcam_weights``, ``grad_cam``, ``grad_cam_confidence`` and
``cs_gradcam``).

The Grad-CAM weights are input-independent: computed once on a zero
image.  Per class c, the gradient of the pre-sigmoid logit y_c with
respect to the final conv activations is normalized by its RMS
(``g / (sqrt(mean(g^2)) + 1e-5)``) and averaged over space into a static [F, C] matrix, in the model's compute
dtype.  The 02_cues CAM (``grad_cam``) applies ReLU before any resize and
masks by the passing classes; HistoSegNet's applies ReLU after the
per-map resize, max-normalizes per image and scales by the confidence
scores of the passing classes.  Both compute in float32: bf16 features
and weights are cast up first, as the reference's promotion does.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from wsss_tpu_torch.ops.filters import resize_bilinear


def gradcam_weights(feats_fn: Callable[[torch.Tensor], torch.Tensor],
                    head_fn: Callable[[torch.Tensor], torch.Tensor],
                    input_hw: Tuple[int, int], device) -> torch.Tensor:
    """Static Grad-CAM weight matrix [F, C] from a zero image.

    feats_fn: NHWC image [1, H, W, 3] -> activations [1, h, w, F]
    head_fn:  activations [1, h, w, F] -> pre-sigmoid logits [1, C]
    """
    x0 = torch.zeros((1, input_hw[0], input_hw[1], 3), dtype=torch.float32,
                     device=device)
    with torch.no_grad():
        feats = feats_fn(x0)
    feats = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = head_fn(feats)[0]
        rows = []
        for c in range(logits.shape[0]):
            (g,) = torch.autograd.grad(logits[c], feats, retain_graph=True)
            g = g / (torch.sqrt(torch.mean(torch.square(g))) + 1e-5)
            rows.append(torch.mean(g[0], dim=(0, 1)))
    return torch.stack(rows).t().contiguous().detach()


def grad_cam(feats: torch.Tensor, weights: torch.Tensor,
             is_pass: torch.Tensor) -> torch.Tensor:
    """02_cues CAM (02_cues/utilities.py:128-144): ReLU(feats @ weights)
    times the pass mask.  feats [B,h,w,F], weights [F,C], is_pass bool
    [B,C].  Returns float32 [B,h,w,C].  (The reference's ``keep_inds``
    and ``upsample_hw``, which no caller passes, are left out.)"""
    cams = torch.relu(torch.einsum('bhwf,fc->bhwc', feats.to(torch.float32),
                                   weights.to(torch.float32)))
    return cams * is_pass[:, None, None, :].to(cams.dtype)


def grad_cam_confidence(feats: torch.Tensor, weights: torch.Tensor,
                        is_pass: torch.Tensor, conf_scores: torch.Tensor,
                        upsample_hw: Tuple[int, int]) -> torch.Tensor:
    """HistoSegNet CAM: feats [B,h,w,F] @ weights [F,C], resized (ReLU
    after the resize), per-image max-normalized and scaled by
    conf_scores * is_pass [B, C].  Returns [B, H, W, C]."""
    cams = torch.einsum('bhwf,fc->bhwc', feats.to(torch.float32),
                        weights.to(torch.float32))
    cams = torch.relu(resize_bilinear(cams, upsample_hw))
    cams = cams / torch.clamp(
        torch.amax(cams, dim=(1, 2, 3), keepdim=True), min=1e-7)
    scale = conf_scores * is_pass.to(conf_scores.dtype)
    return cams * scale[:, None, None, :]


def cs_gradcam(gradcam: torch.Tensor, other_ind: int = -1) -> torch.Tensor:
    """Class-specific Grad-CAM: winner-take-all max-minus-second-max maps
    (03c_hsn/utilities.py:367-397).

    gradcam: [B,H,W,C] channel-last.  other_ind: index of the 'Other'
    channel that passes through unchanged (ADP's functional types), or -1
    for none."""
    top2 = torch.topk(gradcam, 2, dim=-1).values
    maxdiff = top2[..., 0] - top2[..., 1]
    # where the maximum is tied maxdiff is 0, so which index wins is moot
    maxind = torch.argmax(gradcam, dim=-1)
    onehot = torch.nn.functional.one_hot(maxind, gradcam.shape[-1]).to(
        gradcam.dtype)
    cs = maxdiff[..., None] * onehot
    if other_ind >= 0:
        cs[..., other_ind] = gradcam[..., other_ind]
    return cs
