"""DSRG losses of the port — deep seeded region growing (counterpart of
``wsss_tpu/methods/dsrg.py``).

Losses from 03a_sec-dsrg/DSRG.py:470-518:
  * balanced seed: cross-entropy vs the *grown* cues, background and
    foreground normalized separately (DSRG.py:479-499)
  * constrain: identical to SEC (DSRG.py:501-518)

The region growing (a tf.py_func over a process pool in the reference,
DSRG.py:7-62,339-372) is the flood fill of ``ops.region_grow`` on the
tensors' device, with no gradient, like the reference's py_func.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from wsss_tpu_torch.methods.sec import constrain_loss, crf_layer
from wsss_tpu_torch.models.deeplab import sp_softmax
from wsss_tpu_torch.ops.filters import resize_bilinear
from wsss_tpu_torch.ops.region_grow import region_grow


def balanced_seed_loss(softmax: torch.Tensor, cues: torch.Tensor
                       ) -> torch.Tensor:
    """DSRG.py:479-499: bg and fg seed CE normalized separately."""
    count_bg = torch.sum(cues[..., :1], dim=(1, 2, 3), keepdim=True)
    loss_bg = -torch.mean(torch.sum(
        cues[..., :1] * torch.log(softmax[..., :1]),
        dim=(1, 2, 3), keepdim=True) / (count_bg + 1e-8))
    count_fg = torch.sum(cues[..., 1:], dim=(1, 2, 3), keepdim=True)
    loss_fg = -torch.mean(torch.sum(
        cues[..., 1:] * torch.log(softmax[..., 1:]),
        dim=(1, 2, 3), keepdim=True) / (count_fg + 1e-8))
    return loss_bg + loss_fg


def dsrg_losses(logits: torch.Tensor, cues: torch.Tensor,
                labels: torch.Tensor, imgs_raw: torch.Tensor, crf_cfg
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full DSRG objective from FCN logits [B,41,41,C].

    labels: [B,C] image tags incl. background channel (always 1)."""
    sm = sp_softmax(logits)
    new_cues = region_grow(cues, sm.detach(), labels)
    imgs_seed = resize_bilinear(imgs_raw, tuple(logits.shape[1:3]))
    crf_log = crf_layer(sm, imgs_seed, crf_cfg)
    l_seed = balanced_seed_loss(sm, new_cues)
    l_constrain = constrain_loss(sm, crf_log)
    total = l_seed + l_constrain
    return total, {'seed': l_seed, 'constrain': l_constrain,
                   'grown_px': torch.sum(new_cues) - torch.sum(cues)}
