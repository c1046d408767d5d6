"""HistoSegNet's VOC2012 pipeline from ``voc_vgg16_fgbg``'s file, plain:
normalize -> the fg and bg classifiers -> confidence-scaled Grad-CAM ->
the fg/bg merge (the CRF's unaries) -> mean field.

Grad-CAM weights [F, C] are input-independent: from a zero image (not
normalized), the gradient of each class's pre-sigmoid logit with respect
to the final activations, divided by its RMS plus 1e-5 and averaged over
space.  A CAM is ReLU(resize(feats @ weights)), divided by its image's
maximum (at least 1e-7) and scaled by score * (score >= threshold).  The
background channel is bg_scale * sigmoid(max - X_bg), X_bg the sum of the
bg network's CAMs and the max taken over the whole batch."""
from __future__ import annotations

from typing import Sequence

import torch

from benchmark.reference import crf as crf_ref
from benchmark.reference import nets
from benchmark.reference.numerics import Numerics


def normalize(cfg_norm: dict, img: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(cfg_norm['mean'], dtype=torch.float32,
                           device=img.device)
    std = torch.as_tensor(cfg_norm['std'], dtype=torch.float32,
                          device=img.device)
    return ((img * cfg_norm['scale'] - mean) / std) * cfg_norm['post_scale']


def gradcam_weights(num: Numerics, cfg: dict, layers: Sequence):
    s = cfg['input_size']
    dev = layers[0][0].device
    with torch.no_grad():
        _, feats = nets.vgg_classifier(num, cfg, layers,
                                       torch.zeros((1, s, s, 3), device=dev))
    feats = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = nets.vgg_head_logits(num, layers, feats)[0]
        rows = []
        for c in range(logits.shape[0]):
            (g,) = torch.autograd.grad(logits[c], feats, retain_graph=True)
            g = g / (torch.sqrt(torch.mean(g * g)) + 1e-5)
            rows.append(g[0].mean(dim=(0, 1)))
    return torch.stack(rows, 1).detach()


class HSNReference:
    def __init__(self, num: Numerics, cfg: dict, fg: Sequence,
                 bg: Sequence):
        self.num, self.cfg, self.nets = num, cfg, (fg, bg)
        self.weights = [gradcam_weights(num, cfg, n) for n in self.nets]

    @torch.no_grad()
    def _cams(self, layers, weights, x):
        cfg = self.cfg
        scores, feats = nets.vgg_classifier(self.num, cfg, layers, x)
        s = cfg['input_size']
        cams = self.num.einsum('bhwf,fc->bhwc', feats, weights)
        cams = torch.relu(crf_ref.resize_bilinear(cams, (s, s)))
        cams = cams / torch.clamp(cams.amax(dim=(1, 2, 3), keepdim=True),
                                  min=1e-7)
        scale = scores * (scores >= cfg['cam_threshold']).float()
        return cams * scale[:, None, None, :]

    @torch.no_grad()
    def probs(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs [B, S, S, 3] float 0..255 -> unaries [B, S, S, 1 + C]."""
        x = normalize(self.cfg['norm'], imgs)
        h_fg = self._cams(self.nets[0], self.weights[0], x)
        x_bg = self._cams(self.nets[1], self.weights[1], x).sum(-1)
        bg = self.cfg['bg_scale'] * torch.sigmoid(x_bg.amax() - x_bg)
        return torch.cat([bg[..., None], h_fg], dim=-1)

    @torch.no_grad()
    def crf(self, probs: torch.Tensor, imgs: torch.Tensor) -> torch.Tensor:
        return crf_ref.mean_field(self.num, probs, imgs, self.cfg['crf'],
                                  self.cfg['crf_grid'],
                                  self.cfg['dense_crf_max_pixels'])
