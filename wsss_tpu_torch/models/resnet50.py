"""ResNet50 CAM/IRN variant of the port (counterpart of
``wsss_tpu/models/resnet50.py``; the reference's legacy
03b_irn/net/resnet50.py, resnet50_cam.py, resnet50_irn.py — dead in its
dispatch, func_sample.py:40-41, kept for inventory parity).

Bottleneck ResNet50 with FixedBatchNorm (stored statistics always,
resnet50.py:11-14; eps 1e-5, not the classifiers' 1e-3), stage strides
(2,2,2,1) and dilation on the last stage for the CAM variant
(resnet50_cam.py:12).  No ImageNet weights: the reference loads none
either; weights come from the flax bridge or training.

Layout is the JAX package's: ``forward`` takes NHWC images; the stage
maps are returned NCHW, as ``VGG16Backbone`` returns them.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn


class FixedBatchNorm(nn.Module):
    """BatchNorm that always uses stored statistics: ``scale`` / ``bias``
    parameters, ``mean`` / ``var`` buffers, ``(x - mean) * rsqrt(var +
    1e-5) * scale + bias`` on NCHW."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + 1e-5) * self.scale
        return ((x - self.mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None])


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 x4, each with FixedBatchNorm;
    a 1x1 strided projection of the input where ``downsample``."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(in_ch, planes, 1, bias=False),
            nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                      dilation=dilation, bias=False),
            nn.Conv2d(planes, planes * 4, 1, bias=False)])
        self.bns = nn.ModuleList([FixedBatchNorm(planes),
                                  FixedBatchNorm(planes),
                                  FixedBatchNorm(planes * 4)])
        self.downsample_conv = self.downsample_bn = None
        if downsample:
            # flax's SAME padding pads nothing for a 1x1 kernel
            self.downsample_conv = nn.Conv2d(in_ch, planes * 4, 1,
                                             stride=stride, bias=False)
            self.downsample_bn = FixedBatchNorm(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            h = bn(conv(h))
            if i < 2:
                h = torch.relu(h)
        res = x
        if self.downsample_conv is not None:
            res = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(h + res)


class ResNet50(nn.Module):
    """Stages with configurable strides/dilations (resnet50.py:58-76).

    The reference's stride semantics (resnet50.py:61-69): strides[0] is
    the stem conv1's stride, layer1 is always stride 1, layers 2-4 take
    strides[1:]; within a stage only the first block strides and only the
    later blocks dilate (resnet50.py:85-88).  ``forward`` (NCHW) returns 5
    maps: the stem after its max-pool (64 ch), then layer1..layer4 — the
    stage list the IRN heads tap (resnet50_irn.py:15-19).  ``blocks[s][b]``
    is the flax ``layer{s+1}_b{b}``."""

    def __init__(self, strides: Sequence[int] = (2, 2, 2, 1),
                 dilations: Sequence[int] = (1, 1, 1, 2),
                 layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=strides[0], padding=3,
                               bias=False)
        self.bn1 = FixedBatchNorm(64)
        # flax's max_pool pads with -inf, as MaxPool2d does
        self.pool = nn.MaxPool2d(3, 2, 1)
        stage_strides = (1,) + tuple(strides[1:])
        ch, stages = 64, []
        for n, planes, st, dil in zip(layers, (64, 128, 256, 512),
                                      stage_strides, dilations):
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(ch, planes,
                                         stride=st if bi == 0 else 1,
                                         dilation=1 if bi == 0 else dil,
                                         downsample=bi == 0))
                ch = planes * 4
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.out_ch = ch

    def forward(self, x: torch.Tensor):
        h = self.pool(torch.relu(self.bn1(self.conv1(x))))
        feats = [h]
        for stage in self.blocks:
            for block in stage:
                h = block(h)
            feats.append(h)
        return feats


class ResNet50CAM(nn.Module):
    """resnet50_cam.py Net: GAP + a 1x1 classifier (no bias) on stage 4
    (2048 ch); the CAM is the classifier conv applied spatially."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.backbone = ResNet50()
        self.classifier = nn.Conv2d(self.backbone.out_ch, num_classes, 1,
                                    bias=False)

    def _feats(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x.permute(0, 3, 1, 2))[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits [B, C] of NHWC images."""
        pooled = torch.mean(self._feats(x), dim=(2, 3), keepdim=True)
        return self.classifier(pooled)[:, :, 0, 0]

    def cam(self, x: torch.Tensor) -> torch.Tensor:
        """Spatial CAM [B, h, w, C] (NHWC): ReLU(classifier conv over the
        features) (resnet50_cam.py:46-63)."""
        return torch.relu(self.classifier(self._feats(x))).permute(0, 2, 3, 1)
