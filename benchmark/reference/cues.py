"""Grad-CAM cues of VOC2012 (02_cues) from ``voc_vgg16_fgbg``'s file,
plain: normalize -> the fg and bg classifiers -> CAMs ReLU(feats @
weights) masked by the classes that pass (score >= the class threshold
and tagged), resized to the seed grid.  Background cues: the bg CAMs
summed over classes, a 3x3 median (edge replicated), the pixels strictly
below the image's element int(decile * h * w) in ascending order.
Foreground: CAM > threshold x the class's maximum over the whole batch.
Overlaps resolve largest mask first (ties in class order): a pixel goes
to the covering class whose turn comes last.  Packed as the pickle's
'{i}_labels' (passing fg classes + 1) and '{i}_cues' (the [3, N]
class, row, column indices)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import crf as crf_ref
from benchmark.reference import nets
from benchmark.reference.hsn import gradcam_weights, normalize
from benchmark.reference.numerics import Numerics


def median3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median of [B, H, W], the edge sample repeated."""
    b, h, w = x.shape
    p = F.pad(x[:, None], (1, 1, 1, 1), mode='replicate')[:, 0]
    win = torch.stack([p[:, i:i + h, j:j + w] for i in range(3)
                       for j in range(3)], -1)
    return win.sort(-1).values[..., 4]


def resolve_overlap(loc: torch.Tensor) -> torch.Tensor:
    b, h, w, c = loc.shape
    out = torch.zeros_like(loc)
    for i in range(b):
        counts = loc[i].sum(dim=(0, 1)).tolist()
        order = sorted(range(c), key=lambda k: -counts[k])   # stable
        owner = torch.full((h, w), -1, dtype=torch.long, device=loc.device)
        for k in order:
            owner[loc[i, ..., k]] = k
        for k in range(c):
            out[i, ..., k] = owner == k
    return out


class CueReference:
    def __init__(self, num: Numerics, cfg: dict, fg: Sequence,
                 bg: Sequence):
        self.num, self.cfg, self.nets = num, cfg, (fg, bg)
        self.weights = [gradcam_weights(num, cfg, n) for n in self.nets]

    @torch.no_grad()
    def cams(self, layers, weights, x, tags):
        c = self.cfg['cues']
        scores, feats = nets.vgg_classifier(self.num, self.cfg, layers, x)
        passing = (scores >= c['class_threshold']) & (tags > 0.5)
        cams = torch.relu(self.num.einsum('bhwf,fc->bhwc', feats, weights))
        cams = cams * passing[:, None, None, :].float()
        g = c['seed_size']
        return crf_ref.resize_bilinear(cams, (g, g)), passing

    @torch.no_grad()
    def run(self, imgs: torch.Tensor, tags: torch.Tensor,
            indices: Sequence[int]) -> Dict[str, object]:
        """imgs [B, S, S, 3] float 0..255, tags [B, C] -> the fg and bg
        seed CAMs and the batch's packed cues."""
        c = self.cfg['cues']
        x = normalize(self.cfg['norm'], imgs)
        fg, passing = self.cams(self.nets[0], self.weights[0], x, tags)
        bg, _ = self.cams(self.nets[1], self.weights[1], x, tags)
        g = median3(bg.sum(-1))
        b, h, w = g.shape
        thr = g.reshape(b, -1).sort(1).values[:, int(c['bg_decile'] * h * w)]
        bg_cue = g < thr[:, None, None]
        fg_cue = fg > c['threshold'] * fg.amax(dim=(0, 1, 2), keepdim=True)
        onehot = resolve_overlap(torch.cat([bg_cue[..., None], fg_cue], -1))
        oh = onehot.cpu().numpy()
        packed = {}
        for i, idx in enumerate(indices):
            packed[f'{idx}_labels'] = np.where(
                passing[i].cpu().numpy())[0] + 1
            packed[f'{idx}_cues'] = np.array(np.where(np.moveaxis(oh[i], -1,
                                                                  0)))
        return {'fg': fg, 'bg': bg, 'cues': packed}
