"""SEC on DeepLab-LargeFOV from ``sec_voc_largefov``'s file, plain.

Training step (Kolesnikov & Lampert, arXiv:1603.06098): softmax with a
``min_prob`` floor, renormalized; the seed loss (cue-masked
cross-entropy over the cue count); the expand loss (global weighted-rank
pooling with decay q_fg over each foreground class and q_bg over the
background, ascending sort, plus -log(1 - max p) for absent classes);
the constrain loss KL(CRF(p) || p), the CRF on the seed grid with the
image resized to it and no gradient through it; their sum's backward;
SGD with momentum, lr = base_lr * lr_decay^(updates // steps_per_decay)
times each group's multiplier (conv kernels, biases, fc8's kernel,
fc8's bias) and weight decay on the kernels, added before the momentum
trace."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import crf as crf_ref
from benchmark.reference import nets
from benchmark.reference.hsn import normalize
from benchmark.reference.numerics import Numerics


def _decay(q: float, n: int, device) -> torch.Tensor:
    w = np.array([q ** i for i in range(n - 1, -1, -1)], np.float64)
    return torch.as_tensor(w.astype(np.float32), device=device)


def losses(num: Numerics, cfg: dict, logits, cues, tags, imgs_raw
           ) -> Dict[str, torch.Tensor]:
    mp = cfg['min_prob']
    sm = torch.softmax(logits, dim=-1) + mp
    sm = sm / sm.sum(-1, keepdim=True)
    b, h, w, c = sm.shape
    with torch.no_grad():
        seed_imgs = crf_ref.resize_bilinear(imgs_raw, (h, w))
        q = crf_ref.mean_field(num, sm.detach(), seed_imgs,
                               cfg['crf_train'], cfg['crf_grid'],
                               cfg['dense_crf_max_pixels'])
        q = torch.clamp(q, min=mp)
        crf_log = torch.log(q / q.sum(-1, keepdim=True))
    count = torch.clamp(cues.sum(dim=(1, 2, 3)), min=1e-5)
    seed = -torch.mean((cues * torch.log(sm)).sum(dim=(1, 2, 3)) / count)

    n = h * w
    stat = (tags[:, 1:] > 0).float()
    fg = torch.sort(sm[..., 1:].reshape(b, n, c - 1), dim=1,
                    stable=True).values
    w_fg = _decay(cfg['q_fg'], n, sm.device)[None, :, None]
    mean_fg = (fg * w_fg / w_fg.sum()).sum(1)
    bgs = torch.sort(sm[..., 0].reshape(b, n), dim=1, stable=True).values
    w_bg = _decay(cfg['q_bg'], n, sm.device)[None, :]
    mean_bg = (bgs * w_bg / w_bg.sum()).sum(1)
    top = sm[..., 1:].reshape(b, n, c - 1).amax(1)
    l1 = -torch.mean((stat * torch.log(mean_fg) / torch.clamp(
        stat.sum(1, keepdim=True), min=1e-5)).sum(1))
    l2 = -torch.mean(((1 - stat) * torch.log(torch.clamp(1 - top, min=1e-7))
                      / torch.clamp((1 - stat).sum(1, keepdim=True),
                                    min=1e-5)).sum(1))
    l3 = -torch.mean(torch.log(mean_bg))
    expand = l1 + l2 + l3
    constrain = torch.mean((torch.exp(crf_log)
                            * (crf_log - torch.log(sm))).sum(-1))
    return {'seed': seed, 'expand': expand, 'constrain': constrain}


def group_of(index: int, n_layers: int, is_bias: bool) -> str:
    last = index == n_layers - 1
    if last:
        return 'final_bias' if is_bias else 'final_kernel'
    return 'bias' if is_bias else 'kernel'


class Trainer:
    """The reference's training of ``layers`` (copied, so the caller's
    stay as they are)."""

    def __init__(self, num: Numerics, cfg: dict, layers: Sequence):
        self.num, self.cfg = num, cfg
        self.params: List[torch.Tensor] = []
        self.groups: List[str] = []
        for i, (w, b) in enumerate(layers):
            for t, is_bias in ((w, False), (b, True)):
                self.params.append(t.detach().clone().requires_grad_(True))
                self.groups.append(group_of(i, len(layers), is_bias))
        self.bufs: List = [None] * len(self.params)
        self.updates = 0

    def layers(self):
        p = self.params
        return [(p[i], p[i + 1]) for i in range(0, len(p), 2)]

    def step(self, imgs_raw, cues, tags, generator) -> Dict[str, float]:
        cfg, opt = self.cfg, self.cfg['optimizer']
        logits = nets.deeplab(self.num, cfg, self.layers(),
                              normalize(cfg['norm'], imgs_raw), generator)
        parts = losses(self.num, cfg, logits, cues, tags, imgs_raw)
        total = parts['seed'] + parts['expand'] + parts['constrain']
        grads = torch.autograd.grad(total, self.params)
        lr = np.float32(opt['base_lr']) * np.float32(opt['lr_decay']) ** \
            np.float32(self.updates // opt['steps_per_decay'])
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(self.params, grads)):
                grp = self.groups[i]
                if grp.endswith('kernel'):
                    g = g + opt['weight_decay'] * p
                if self.bufs[i] is None:
                    self.bufs[i] = g.clone()
                else:
                    self.bufs[i].mul_(opt['momentum']).add_(g)
                p.sub_(float(lr) * opt['multipliers'][grp] * self.bufs[i])
        self.updates += 1
        out = {k: float(v.detach()) for k, v in parts.items()}
        out['total'] = float(total.detach())
        return out
