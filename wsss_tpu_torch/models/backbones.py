"""Classifier backbones of the port: VGG16 and M7 (counterparts of
``wsss_tpu/models/backbones.py``).

Inside a stage each conv is 3x3 with padding 1, then ReLU, then
BatchNorm (eps 1e-3) — the reference's deliberate conv -> ReLU -> BN
order.  'M' is a 2x2 max-pool with floor (321 -> 160 -> 80 -> 40), 'D'
a dropout that is off in eval.  VGG16 pools its final map by its mean
(GAP head), M7 by its max.

Public layout is the JAX package's: ``forward`` takes NHWC images and
returns ``(scores [B, C], feats [B, h, w, F])``; the convolutions run on
the NCHW view of the same memory (channels-last strides).
"""
from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import torch
import torch.nn as nn

VGG16_CFG: Tuple[Tuple[Any, ...], ...] = (
    (64, 64, 'M'), (128, 128, 'M'), (256, 256, 256, 'M'),
    (512, 512, 512, 512, 512, 512), (1024, 'D', 1024, 'D'))
M7_CFG: Tuple[Tuple[Any, ...], ...] = (
    (64, 64, 'M'), (128, 128, 'M'), (256, 256, 256), ('M', 'D'))


class VGGStage(nn.Module):
    """One cfg stage on NCHW tensors: conv -> ReLU -> BN per width,
    'M' pools, 'D' drops.  ``convs[i]`` / ``bns[i]`` are the flax stage's
    ``Conv_i`` / ``BatchNorm_i``."""

    def __init__(self, cfg: Sequence[Any], in_ch: int):
        super().__init__()
        self.cfg = tuple(cfg)
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        ch = in_ch
        for v in self.cfg:
            if v in ('M', 'D'):
                continue
            self.convs.append(nn.Conv2d(ch, int(v), 3, padding=1))
            self.bns.append(nn.BatchNorm2d(int(v), eps=1e-3, momentum=0.01))
            ch = int(v)
        self.out_ch = ch
        self.pool = nn.MaxPool2d(2, 2)
        self.drop = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for v in self.cfg:
            if v == 'M':
                x = self.pool(x)
            elif v == 'D':
                x = self.drop(x)
            else:
                x = self.bns[i](torch.relu(self.convs[i](x)))
                i += 1
        return x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _Classifier(nn.Module):
    """Shared forward of the multi-label classifiers: trunk -> pool ->
    Linear -> sigmoid."""
    global_max = False

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pool_feats(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, h, w, F] NHWC -> [B, F]: max for M7, mean for VGG16."""
        if self.global_max:
            return torch.amax(feats, dim=(1, 2))
        return torch.mean(feats, dim=(1, 2))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> final conv activations [B, h, w, F] (NHWC)."""
        return _nhwc(self.trunk(_nchw(x)))

    def forward(self, x: torch.Tensor):
        feats = self.features(x)
        logits = self.head(self.drop(self.pool_feats(feats)))
        return torch.sigmoid(logits), feats


class VGG16Backbone(nn.Module):
    """Five-stage VGG16 trunk on NCHW tensors; returns every stage's
    output (strides 1, 2, 4, 8, 8: stages 4 and 5 do not pool)."""

    def __init__(self):
        super().__init__()
        stages, ch = [], 3
        for cfg in VGG16_CFG:
            stages.append(VGGStage(cfg, ch))
            ch = stages[-1].out_ch
        self.stages = nn.ModuleList(stages)
        self.out_ch = ch

    def forward(self, x: torch.Tensor):
        feats = []
        for s in self.stages:
            x = s(x)
            feats.append(x)
        return feats


class VGG16Classifier(_Classifier):
    """Multi-label VGG16 (GAP head); feats at /8, 1024 wide."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.backbone = VGG16Backbone()
        self.drop = nn.Identity()
        self.head = nn.Linear(self.backbone.out_ch, num_classes)

    def trunk(self, x):
        return self.backbone(x)[-1]


class M7Classifier(_Classifier):
    """M7 HistoNet (global-max head).  feats is the last conv stage's
    output (layer3_p1); the trailing 2x2 max-pool is subsumed by the
    global max, then dropout."""
    global_max = True

    def __init__(self, num_classes: int):
        super().__init__()
        self.layer1 = VGGStage(M7_CFG[0], 3)
        self.layer2 = VGGStage(M7_CFG[1], self.layer1.out_ch)
        self.layer3_p1 = VGGStage(M7_CFG[2], self.layer2.out_ch)
        self.drop = nn.Dropout(0.5)
        self.head = nn.Linear(self.layer3_p1.out_ch, num_classes)

    def trunk(self, x):
        return self.layer3_p1(self.layer2(self.layer1(x)))


def build_classifier(model_type: str, num_classes: int) -> _Classifier:
    """'VGG16', 'M7' or 'X1.7' (the M7 trunk with ADP's 51-way head), all
    with BatchNorm."""
    mt = model_type.upper()
    if mt == 'VGG16':
        return VGG16Classifier(num_classes)
    if mt in ('M7', 'X1.7'):
        return M7Classifier(num_classes)
    raise ValueError(f'model_type {model_type!r} is not ported yet '
                     "(ported: 'VGG16', 'M7', 'X1.7')")


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisation, drawn from ``generator``: LeCun
    truncated-normal conv and dense kernels, zero biases, BN scale 1 /
    bias 0 with running mean 0 / var 1."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(mod.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.weight.copy_(w)
            mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model
