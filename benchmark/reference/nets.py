"""The networks of the configurations, as plain functions of their weights
(NHWC images in, as the configurations' entry points take them).

  * ``vgg_classifier``: HistoSegNet's VGG16 classifier: 3x3 convolutions
    (padding 1) -> ReLU -> BatchNorm per width, 2x2 max-pools (floor),
    dropout as the identity (inference); global mean pooling, a dense
    head and a sigmoid.  Returns (scores [B, C], final activations
    [B, h, w, F]).
  * ``deeplab``: SEC's DeepLab-LargeFOV: VGG16's conv1..conv5 (conv5 at
    dilation 2), 3x3 max-pools with 'SAME' padding (-inf) and strides
    2, 2, 2, 1, 1, a 3x3 stride-1 mean pool counting its zero padding,
    then fc6 (3x3 at dilation 12) -> fc7 (1x1) -> fc8 (1x1), dropout
    after fc6 and fc7 in training.  Returns NHWC logits.

Weights are the benchmark's ``[(kernel, bias), ...]`` in layer order."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.numerics import Numerics


def vgg_classifier(num: Numerics, cfg: dict, layers: Sequence, x_nhwc):
    """BatchNorm at the state the benchmark gives it, its initial one:
    scale 1, bias 0, running mean 0 and variance 1."""
    x = x_nhwc.permute(0, 3, 1, 2)
    i = 0
    bn = 1.0 / math.sqrt(1.0 + cfg['bn_eps'])
    for stage in cfg['stages']:
        for v in stage:
            if v == 'M':
                x = F.max_pool2d(x, 2, 2)
            elif v == 'D':
                continue
            else:
                w, b = layers[i]
                x = torch.relu(num.conv2d(x, w, b, padding=1))
                if cfg['batchnorm']:
                    x = x * bn
                i += 1
    feats = x.permute(0, 2, 3, 1)
    w, b = layers[i]
    logits = num.linear(torch.mean(feats, dim=(1, 2)), w, b)
    return torch.sigmoid(logits), feats


def vgg_head_logits(num: Numerics, layers: Sequence, feats):
    w, b = layers[-1]
    return num.linear(torch.mean(feats, dim=(1, 2)), w, b)


def _same_pad(n: int, window: int, stride: int):
    total = max((-(-n // stride) - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def _max_pool_same(x, window: int, stride: int):
    ph = _same_pad(x.shape[-2], window, stride)
    pw = _same_pad(x.shape[-1], window, stride)
    x = F.pad(x, pw + ph, value=float('-inf'))
    return F.max_pool2d(x, window, stride)


def dropout(x, rate: float, generator: torch.Generator):
    """Keep with probability 1 - rate, scaled by 1 / (1 - rate); the
    uniform draws come from ``generator`` in call order."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def deeplab(num: Numerics, cfg: dict, layers: Sequence, x_nhwc,
            generator: Optional[torch.Generator] = None):
    """generator: training (dropout drawn from it), None: inference."""
    x = x_nhwc.permute(0, 3, 1, 2)
    i = 0
    for n_convs, _, pool_stride, dil in cfg['trunk']:
        for _ in range(n_convs):
            w, b = layers[i]
            x = torch.relu(num.conv2d(x, w, b, padding=dil, dilation=dil))
            i += 1
        x = _max_pool_same(x, cfg['pool_window'], pool_stride)
    x = F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
    rate = cfg['dropout']
    dil = cfg['fc6_dilation']
    for k in range(2):
        w, b = layers[i]
        x = torch.relu(num.conv2d(x, w, b, padding=dil if k == 0 else 0,
                                  dilation=dil if k == 0 else 1))
        if generator is not None:
            x = dropout(x, rate, generator)
        i += 1
    w, b = layers[i]
    x = num.conv2d(x, w, b)
    return x.permute(0, 2, 3, 1)
