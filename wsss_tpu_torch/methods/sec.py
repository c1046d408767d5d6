"""SEC losses of the port — seed, expand, constrain (counterpart of
``wsss_tpu/methods/sec.py``).

Losses re-derived from 03a_sec-dsrg/SEC.py:363-465:
  * seed: cue-masked cross-entropy, normalized by cue count (SEC.py:382-399)
  * expand: global weighted-rank pooling with decay q_fg=0.996 over
    foreground classes / q_bg=0.999 over background, plus a 1-max(prob)
    suppression term for absent classes (SEC.py:401-446)
  * constrain: KL(CRF(softmax) || softmax) (SEC.py:448-465); the CRF runs
    through tf.py_func in the reference (no gradient), here under
    ``torch.no_grad()``.

Tensors are NHWC as in the reference.  The CRF-as-layer runs on the seed
grid (41x41 at 321^2) with the original image bilinearly resized to it
(SEC.py:267-268); at that size ``mean_field`` takes the dense structure,
one matrix product a filter, on any device.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from wsss_tpu_torch.models.deeplab import MIN_PROB, sp_softmax
from wsss_tpu_torch.ops.crf.meanfield import mean_field
from wsss_tpu_torch.ops.filters import resize_bilinear

Q_FG = 0.996  # SEC.py:421
Q_BG = 0.999  # SEC.py:428


@torch.no_grad()
def crf_layer(probs: torch.Tensor, imgs_seed: torch.Tensor, cfg
              ) -> torch.Tensor:
    """CRF-as-layer (SEC.py:252-284): mean-field on the seed grid, floor at
    MIN_PROB, renormalize, return log-probs, with no gradient."""
    q = mean_field(probs.detach(), imgs_seed, cfg)
    q = torch.clamp(q, min=MIN_PROB)
    q = q / torch.sum(q, dim=-1, keepdim=True)
    return torch.log(q)


def seed_loss(softmax: torch.Tensor, cues: torch.Tensor) -> torch.Tensor:
    """SEC.py:382-399. cues: [B,h,w,C] one-hot."""
    count = torch.clamp(torch.sum(cues, dim=(1, 2, 3), keepdim=True),
                        min=1e-5)
    per = torch.sum(cues * torch.log(softmax), dim=(1, 2, 3), keepdim=True)
    return -torch.mean(per / count)


@functools.lru_cache(maxsize=8)
def _decay_np(q: float, n: int) -> np.ndarray:
    """[q^(n-1), ..., q^0] in float64, then float32, as the reference
    builds them from Python floats (a float32 power differs in the last
    bits)."""
    w = np.array([q ** i for i in range(n - 1, -1, -1)], np.float64)
    return w.astype(np.float32)


def _decay_weights(q: float, n: int, device) -> torch.Tensor:
    return torch.as_tensor(_decay_np(q, n), device=device)


def expand_loss(softmax: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """SEC.py:401-446. labels: [B,C] one-hot image-level tags (channel 0 =
    background; stat = labels[:,1:])."""
    b, h, w, c = softmax.shape
    n = h * w
    stat = (labels[:, 1:] > 0).to(torch.float32)
    probs_bg = softmax[..., 0].reshape(b, n)
    probs = softmax[..., 1:].reshape(b, n, c - 1)

    # ascending; stable, as jnp.sort, so tied values keep their order
    probs_sort = torch.sort(probs, dim=1, stable=True).values
    w_fg = _decay_weights(Q_FG, n, softmax.device)[None, :, None]
    probs_mean = torch.sum(probs_sort * w_fg / torch.sum(w_fg), dim=1)

    probs_bg_sort = torch.sort(probs_bg, dim=1, stable=True).values
    w_bg = _decay_weights(Q_BG, n, softmax.device)[None, :]
    probs_bg_mean = torch.sum(probs_bg_sort * w_bg / torch.sum(w_bg), dim=1)

    # amax splits the gradient among tied maxima, as jnp.max does
    probs_max = torch.amax(probs, dim=1)

    loss_1 = -torch.mean(torch.sum(
        stat * torch.log(probs_mean)
        / torch.clamp(torch.sum(stat, 1, keepdim=True), min=1e-5), dim=1))
    loss_2 = -torch.mean(torch.sum(
        (1 - stat) * torch.log(torch.clamp(1 - probs_max, min=1e-7))
        / torch.clamp(torch.sum(1 - stat, 1, keepdim=True), min=1e-5),
        dim=1))
    loss_3 = -torch.mean(torch.log(probs_bg_mean))
    return loss_1 + loss_2 + loss_3


def constrain_loss(softmax: torch.Tensor, crf_log: torch.Tensor
                   ) -> torch.Tensor:
    """SEC.py:448-465: KL(exp(crf_log) || softmax)."""
    p = torch.exp(crf_log)
    return torch.mean(torch.sum(p * (crf_log - torch.log(softmax)), dim=-1))


def sec_losses(logits: torch.Tensor, cues: torch.Tensor,
               labels: torch.Tensor, imgs_raw: torch.Tensor, crf_cfg
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full SEC objective from FCN logits [B,41,41,C].

    imgs_raw: [B,H,W,3] RGB 0..255 (the reference reconstructs the image
    by adding back the mean before the CRF, SEC.py:267; the raw image is
    carried instead — identical values)."""
    sm = sp_softmax(logits)
    imgs_seed = resize_bilinear(imgs_raw, tuple(logits.shape[1:3]))
    crf_log = crf_layer(sm, imgs_seed, crf_cfg)
    l_seed = seed_loss(sm, cues)
    l_expand = expand_loss(sm, labels)
    l_constrain = constrain_loss(sm, crf_log)
    total = l_seed + l_expand + l_constrain
    return total, {'seed': l_seed, 'expand': l_expand,
                   'constrain': l_constrain}
