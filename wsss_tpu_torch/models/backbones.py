"""Classifier backbones of the port: VGG16 (with or without BatchNorm),
M7 / X1.7 and the M1-M6 variants (counterparts of
``wsss_tpu/models/backbones.py``).

Inside a stage each conv is 3x3 with padding 1, then ReLU, then
BatchNorm (eps 1e-3) where the model has it — the reference's deliberate
conv -> ReLU -> BN order.  'M' is a 2x2 max-pool with floor (321 -> 160
-> 80 -> 40), 'D' a dropout of rate 0.5.  VGG16 pools its final map by
its mean (GAP head), M7 and the M variants by their max, then drop out.

Train mode (``model.train()``) is flax's ``train=True``: BatchNorm
normalizes with the batch's biased variance and moves its running
statistics by ``ra = 0.99 ra + 0.01 stat`` with that same biased
variance (``torch.nn.BatchNorm2d`` would keep the unbiased one), and each
dropout draws its mask through ``dropout`` from the ``generator`` the
forward was given (``torch.nn.Dropout`` takes none).  Eval mode uses the
running statistics and drops nothing.

Public layout is the JAX package's: ``forward`` takes NHWC images and
returns ``(scores [B, C], feats [B, h, w, F])``; the convolutions run on
the NCHW view of the same memory (channels-last strides).

Compute dtype (``dtype=``): parameters stay float32 and
are cast where they are used, as flax's ``dtype`` does.  Under bfloat16
each conv and the head run on bf16 inputs, weights and biases (flax
rounds the product to bf16 before its bias add, the library may add the
bias before rounding: at most one bf16 rounding apart); BatchNorm
computes in float32 and rounds once (see ``VGGStage.forward``); the
head's logits return to float32 before the sigmoid.  Float32 models run
the modules' own forward, unchanged.
"""
from __future__ import annotations

import math
import os
from typing import Any, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from wsss_tpu_torch.parallel.mesh import cross_shard_sum, current_shard

VGG16_CFG: Tuple[Tuple[Any, ...], ...] = (
    (64, 64, 'M'), (128, 128, 'M'), (256, 256, 256, 'M'),
    (512, 512, 512, 512, 512, 512), (1024, 'D', 1024, 'D'))
M7_CFG: Tuple[Tuple[Any, ...], ...] = (
    (64, 64, 'M'), (128, 128, 'M'), (256, 256, 256), ('M', 'D'))
# the reference's re-derived "vgg16_experimental" family (its M7 entry is
# unreachable there: 'M7' builds M7Classifier)
M_VARIANT_CFGS = {
    'M1': ((64, 64, 'M'), (128, 128, 'M'), (256, 256, 256, 'M'),
           (512, 512, 512, 'M'), (512, 512, 512)),
    'M2': ((64, 64, 'M'), (128, 128, 'M'), (256, 256, 256, 'M'),
           (512, 512, 512, 'M')),
    'M3': ((64, 64, 'M'), (128, 128, 'M'), (256, 256, 256, 'M'),
           (512, 512, 512)),
    'M4': ((64, 64, 'M'), (128, 128, 'M'), (256, 256, 256, 'M'),
           (384, 384)),
    'M5': ((64, 64, 'M'), (128, 128, 'M'), (256, 256, 256, 'M')),
    'M6': ((64, 64, 'M'), (128, 128, 'M'), (256, 256, 384)),
}


def infer_dtype() -> torch.dtype:
    """Compute dtype of inference-only classifier builds, the reference's
    switches with its truthiness (any non-empty value):
    WSSS_TPU_NO_BF16_INFER forces float32, else WSSS_TPU_BF16_INFER
    forces bfloat16, else float32.  (The reference defaults to bfloat16
    on its TPU backend only; the port keeps float32 on the card unless
    asked.)"""
    if os.environ.get('WSSS_TPU_NO_BF16_INFER'):
        return torch.float32
    if os.environ.get('WSSS_TPU_BF16_INFER'):
        return torch.bfloat16
    return torch.float32


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax's ``nn.Dropout(rate)`` in train mode: keep each element with
    probability 1 - rate and scale it by 1 / (1 - rate), zero the rest.
    The mask is drawn from ``generator``, which must live on x's device
    (flax's masks come from another stream: same distribution, other
    masks)."""
    if generator is None:
        raise ValueError('dropout in train mode needs a torch.Generator')
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class Dropout(nn.Module):
    """Identity in eval mode, ``dropout`` in train mode (looked up at call
    time, so one replacement reaches every model)."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if not self.training:
            return x
        step = current_shard()
        if step is not None:
            return _shard_dropout(step, x, self.rate)
        return dropout(x, self.rate, generator)


def _shard_dropout(step, x: torch.Tensor, rate: float) -> torch.Tensor:
    """``dropout`` of one shard inside a data-parallel step: its rows of
    the keep mask that ``dropout`` draws once for the global batch's
    shape, from the step's generator on shard 0's device, as the
    unsharded call draws it."""
    def combine(shapes):
        rows = [s[0] for s in shapes]
        ones = torch.ones((sum(rows),) + tuple(shapes[0][1:]),
                          dtype=x.dtype, device=step.devices[0])
        keep = dropout(ones, rate, step.generator) != 0
        return [k.to(d) for k, d in zip(torch.split(keep, rows),
                                        step.devices)]
    keep = step.meet(tuple(x.shape), combine)
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` on NCHW ``x``; in train mode flax's BatchNorm(momentum 0.99):
    batch mean and biased variance (E[x^2] - E[x]^2, flax's fast variance,
    floored at 0) in at least float32, the running statistics moved towards
    them, the result in x's dtype.  Inside a data-parallel step
    (``parallel.mesh.run_shards``) the batch is the global one: every
    replica normalizes with, and moves its running statistics by, the
    same global values."""
    if not bn.training:
        return bn(x)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    step = current_shard()
    if step is None:
        mean = xf.mean((0, 2, 3))
        ex2 = (xf * xf).mean((0, 2, 3))
    else:
        # inside a data-parallel step: the global batch's statistics, from
        # the cross-shard sums of every shard's sums and counts
        def combine(parts):
            sums = cross_shard_sum([p[0] for p in parts], step.devices)
            n = sum(p[1] for p in parts)
            return [(s, n) for s in sums]
        part = torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])
        total, n = step.meet((part, x.shape[0] * x.shape[2] * x.shape[3]),
                             combine)
        mean, ex2 = total[0] / n, total[1] / n
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(0.99).add_(0.01 * mean)
        bn.running_var.mul_(0.99).add_(0.01 * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias[:, None, None]
    return y.to(x.dtype)


class VGGStage(nn.Module):
    """One cfg stage on NCHW tensors: conv -> ReLU (-> BN) per width,
    'M' pools, 'D' drops.  ``convs[i]`` / ``bns[i]`` are the flax stage's
    ``Conv_i`` / ``BatchNorm_i``."""

    def __init__(self, cfg: Sequence[Any], in_ch: int,
                 batchnorm: bool = True, dtype=torch.float32):
        super().__init__()
        self.cfg = tuple(cfg)
        self.dtype = dtype
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        ch = in_ch
        for v in self.cfg:
            if v in ('M', 'D'):
                continue
            self.convs.append(nn.Conv2d(ch, int(v), 3, padding=1))
            if batchnorm:
                self.bns.append(nn.BatchNorm2d(int(v), eps=1e-3,
                                               momentum=0.01))
            ch = int(v)
        self.out_ch = ch
        self.pool = nn.MaxPool2d(2, 2)
        self.drop = Dropout(0.5)

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv = self.convs[i]
        if self.dtype == torch.float32:
            return conv(x)
        dt = self.dtype
        return F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                        padding=1)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        i = 0
        for v in self.cfg:
            if v == 'M':
                x = self.pool(x)
            elif v == 'D':
                x = self.drop(x, generator)
            else:
                x = torch.relu(self._conv(i, x))
                if len(self.bns):
                    # on bf16 activations as flax's BatchNorm(dtype=bf16):
                    # its statistics, scale and bias are float32, so the
                    # normalization runs in float32, cast to bf16 once at
                    # the end; the float32 module on a bf16 input computes
                    # the same way in eval
                    x = batch_norm(self.bns[i], x)
                i += 1
        return x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _Classifier(nn.Module):
    """Shared forward of the multi-label classifiers: trunk -> pool
    (-> dropout) -> Linear -> sigmoid.  ``generator`` feeds the dropouts
    in train mode."""
    global_max = True

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.drop = None            # the head's Dropout, where it has one

    def trunk(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        raise NotImplementedError

    def pool_feats(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, h, w, F] NHWC -> [B, F]: max for M7, mean for VGG16."""
        if self.global_max:
            return torch.amax(feats, dim=(1, 2))
        return torch.mean(feats, dim=(1, 2))

    def features(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """NHWC images -> final conv activations [B, h, w, F] (NHWC), in
        the compute dtype."""
        return _nhwc(self.trunk(_nchw(x).to(self.dtype), generator))

    def head_logits(self, feats: torch.Tensor,
                    generator=None) -> torch.Tensor:
        """Pre-sigmoid logits [B, C] of final activations, in the compute
        dtype (the reference's y_c = layers[-2].output)."""
        p = self.pool_feats(feats)
        if self.drop is not None:
            p = self.drop(p, generator)
        if self.dtype == torch.float32:
            return self.head(p)
        dt = self.dtype
        return F.linear(p.to(dt), self.head.weight.to(dt),
                        self.head.bias.to(dt))

    def logits(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """Float32 pre-sigmoid logits [B, C] of NHWC images (flax's
        ``method='logits'``, which the trainer differentiates)."""
        return self.head_logits(self.features(x, generator),
                                generator).to(torch.float32)

    def forward(self, x: torch.Tensor, generator=None):
        feats = self.features(x, generator)
        logits = self.head_logits(feats, generator).to(torch.float32)
        return torch.sigmoid(logits), feats


class VGG16Backbone(nn.Module):
    """Five-stage VGG16 trunk on NCHW tensors; returns every stage's
    output (strides 1, 2, 4, 8, 8: stages 4 and 5 do not pool)."""

    def __init__(self, batchnorm: bool = True, dtype=torch.float32):
        super().__init__()
        stages, ch = [], 3
        for cfg in VGG16_CFG:
            stages.append(VGGStage(cfg, ch, batchnorm, dtype))
            ch = stages[-1].out_ch
        self.stages = nn.ModuleList(stages)
        self.out_ch = ch

    def forward(self, x: torch.Tensor, generator=None):
        feats = []
        for s in self.stages:
            x = s(x, generator)
            feats.append(x)
        return feats


class VGG16Classifier(_Classifier):
    """Multi-label VGG16 (GAP head); feats at /8, 1024 wide."""
    global_max = False

    def __init__(self, num_classes: int, batchnorm: bool = True,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.backbone = VGG16Backbone(batchnorm, dtype)
        self.head = nn.Linear(self.backbone.out_ch, num_classes)

    def trunk(self, x, generator=None):
        return self.backbone(x, generator)[-1]


class M7Classifier(_Classifier):
    """M7 HistoNet (global-max head).  feats is the last conv stage's
    output (layer3_p1); the trailing 2x2 max-pool is subsumed by the
    global max, then dropout."""

    def __init__(self, num_classes: int, dtype=torch.float32):
        super().__init__(dtype)
        self.layer1 = VGGStage(M7_CFG[0], 3, dtype=dtype)
        self.layer2 = VGGStage(M7_CFG[1], self.layer1.out_ch, dtype=dtype)
        self.layer3_p1 = VGGStage(M7_CFG[2], self.layer2.out_ch,
                                  dtype=dtype)
        self.drop = Dropout(0.5)
        self.head = nn.Linear(self.layer3_p1.out_ch, num_classes)

    def trunk(self, x, generator=None):
        for layer in (self.layer1, self.layer2, self.layer3_p1):
            x = layer(x, generator)
        return x


class MVariantClassifier(_Classifier):
    """HistoNet M-variant: VGG stages (``stages[i]`` is the flax
    ``stages_i``) + global-max head."""

    def __init__(self, cfg: Sequence[Sequence[Any]], num_classes: int,
                 dtype=torch.float32):
        super().__init__(dtype)
        stages, ch = [], 3
        for c in cfg:
            stages.append(VGGStage(c, ch, dtype=dtype))
            ch = stages[-1].out_ch
        self.stages = nn.ModuleList(stages)
        self.drop = Dropout(0.5)
        self.head = nn.Linear(ch, num_classes)

    def trunk(self, x, generator=None):
        for s in self.stages:
            x = s(x, generator)
        return x


def build_classifier(model_type: str, num_classes: int,
                     dtype=None) -> _Classifier:
    """The reference's model tags (01_train/demo.py:24): 'VGG16' (BN),
    'VGG16fg' (no BN), 'VGG16fg_bn', 'M1'..'M7', 'X1.7' (the M7 trunk,
    ADP's 51-way head).  BatchNorm follows the tag (the reference's
    ``batchnorm=`` argument, which no caller passes, is left out).

    dtype: compute dtype, parameters stay float32.  None is the
    reference's default: bfloat16 under WSSS_TPU_BF16_INFER, else float32
    (inference handles pass ``infer_dtype()``)."""
    if dtype is None:
        dtype = (torch.bfloat16 if os.environ.get('WSSS_TPU_BF16_INFER')
                 else torch.float32)
    mt = model_type.upper()
    if mt.startswith('VGG16'):
        return VGG16Classifier(num_classes, mt in ('VGG16', 'VGG16FG_BN'),
                               dtype)
    if mt in ('M7', 'X1.7'):
        return M7Classifier(num_classes, dtype)
    if mt in M_VARIANT_CFGS:
        return MVariantClassifier(M_VARIANT_CFGS[mt], num_classes, dtype)
    raise ValueError(f'unknown model_type {model_type!r}')


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisation, drawn from ``generator``: LeCun
    truncated-normal conv and dense kernels, zero biases (where a layer
    has one), BN scale 1 / bias 0 with running mean 0 / var 1, GroupNorm
    scale 1 / bias 0."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(mod.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
            mod.reset_parameters()
    return model
