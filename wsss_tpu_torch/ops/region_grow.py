"""DSRG seeded region growing of the port (counterpart of
``wsss_tpu/ops/region_grow.py``): a flood fill in plain PyTorch on the
tensors' device.

Semantics (03a_sec-dsrg/DSRG.py:7-62, as the reference keeps them):
  1. existing_prob = softmax * image tags; a pixel is a growth candidate
     for class c iff c is the argmax over tagged classes AND its prob
     passes th_f (foreground) / th_b (background).
  2. For each tagged class (ascending order!), every candidate pixel
     8-connected to an existing cue of that class becomes a new cue —
     except pixels already cued to a *different* class.
  3. Classes are grown sequentially: class c's additions are visible to
     class c+1's conflict check.

The fill dilates the seed set inside the candidate mask until it stops
growing.  The reference tests for the fixpoint after every dilation
(``lax.while_loop``); here the host reads the count once every
``CHECK_EVERY`` dilations, which is exact because a dilation past the
fixpoint changes nothing.  Classes that no image of the batch is tagged
with are skipped, also exactly: their candidate mask is empty, so their
cues stay as they are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHECK_EVERY = 8


def _dilate8(mask: torch.Tensor) -> torch.Tensor:
    """8-connected binary dilation of [B,H,W] bool (3x3 max pool, the
    outside counting as False)."""
    return F.max_pool2d(mask[:, None].to(torch.float32), 3, 1, 1)[:, 0] > 0


def _flood_fill(seed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pixels of `mask` reachable from `seed` by 8-connected steps
    ([B,H,W] bool each)."""
    grow = seed & mask
    n = int(grow.sum())
    while True:
        for _ in range(CHECK_EVERY):
            grow = (_dilate8(grow) & mask) | grow
        n_new = int(grow.sum())
        if n_new == n:
            return grow
        n = n_new


@torch.no_grad()
def region_grow(cues: torch.Tensor, probs: torch.Tensor, tags: torch.Tensor,
                th_f: float = 0.5, th_b: float = 0.7) -> torch.Tensor:
    """Grow weak cues by seeded region growing.

    cues:  [B,H,W,C] float/bool one-hot weak cues (channel 0 = background).
    probs: [B,H,W,C] softmax output.
    tags:  [B,C] image-level labels (bg channel set for every image).
    Returns the grown cues [B,H,W,C] float32.
    """
    c = cues.shape[-1]
    cur = cues > 0.5
    tagged = tags > 0.5
    existing = probs * tags[:, None, None, :]
    argmax_c = torch.argmax(existing, dim=-1)                   # [B,H,W]
    fg_pass = torch.any(existing[..., 1:] > th_f, dim=-1)
    bg_pass = existing[..., 0] > th_b
    passes = torch.where(argmax_c > 0, fg_pass, bg_pass)
    cand = (F.one_hot(argmax_c, c).to(torch.bool) & passes[..., None]
            & tagged[:, None, None, :])
    for ci in torch.nonzero(tagged.any(0)).flatten().tolist():
        seed = cur[..., ci]
        reach = _flood_fill(seed, cand[..., ci])
        cued_elsewhere = (cur.sum(-1) == 1) & ~seed
        cur[..., ci] = seed | (reach & ~cued_elsewhere)
    return cur.to(torch.float32)
