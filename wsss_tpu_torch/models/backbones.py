"""Classifier backbones of the port: VGG16 (with or without BatchNorm),
M7 / X1.7 and the M1-M6 variants (counterparts of
``wsss_tpu/models/backbones.py``).

Inside a stage each conv is 3x3 with padding 1, then ReLU, then
BatchNorm (eps 1e-3) where the model has it — the reference's deliberate
conv -> ReLU -> BN order.  'M' is a 2x2 max-pool with floor (321 -> 160
-> 80 -> 40), 'D' a dropout that is off in eval.  VGG16 pools its final
map by its mean (GAP head), M7 and the M variants by their max.

Public layout is the JAX package's: ``forward`` takes NHWC images and
returns ``(scores [B, C], feats [B, h, w, F])``; the convolutions run on
the NCHW view of the same memory (channels-last strides).

Compute dtype (``dtype=``, inference only): parameters stay float32 and
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
        self.drop = nn.Dropout(0.5)

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv = self.convs[i]
        if self.dtype == torch.float32:
            return conv(x)
        dt = self.dtype
        return F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                        padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for v in self.cfg:
            if v == 'M':
                x = self.pool(x)
            elif v == 'D':
                x = self.drop(x)
            else:
                x = torch.relu(self._conv(i, x))
                if len(self.bns):
                    # on bf16 activations as flax's BatchNorm(dtype=bf16)
                    # in eval: its statistics, scale and bias are float32,
                    # so x - mean promotes and the normalization runs in
                    # float32, cast to bf16 once at the end; the float32
                    # module on a bf16 input computes the same way
                    x = self.bns[i](x)
                i += 1
        return x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _Classifier(nn.Module):
    """Shared forward of the multi-label classifiers: trunk -> pool ->
    Linear -> sigmoid."""
    global_max = True

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pool_feats(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, h, w, F] NHWC -> [B, F]: max for M7, mean for VGG16."""
        if self.global_max:
            return torch.amax(feats, dim=(1, 2))
        return torch.mean(feats, dim=(1, 2))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> final conv activations [B, h, w, F] (NHWC), in
        the compute dtype."""
        return _nhwc(self.trunk(_nchw(x).to(self.dtype)))

    def head_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """Pre-sigmoid logits [B, C] of final activations, in the compute
        dtype (the reference's y_c = layers[-2].output)."""
        p = self.drop(self.pool_feats(feats))
        if self.dtype == torch.float32:
            return self.head(p)
        dt = self.dtype
        return F.linear(p.to(dt), self.head.weight.to(dt),
                        self.head.bias.to(dt))

    def forward(self, x: torch.Tensor):
        feats = self.features(x)
        logits = self.head_logits(feats).to(torch.float32)
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

    def forward(self, x: torch.Tensor):
        feats = []
        for s in self.stages:
            x = s(x)
            feats.append(x)
        return feats


class VGG16Classifier(_Classifier):
    """Multi-label VGG16 (GAP head); feats at /8, 1024 wide."""
    global_max = False

    def __init__(self, num_classes: int, batchnorm: bool = True,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.backbone = VGG16Backbone(batchnorm, dtype)
        self.drop = nn.Identity()
        self.head = nn.Linear(self.backbone.out_ch, num_classes)

    def trunk(self, x):
        return self.backbone(x)[-1]


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
        self.drop = nn.Dropout(0.5)
        self.head = nn.Linear(self.layer3_p1.out_ch, num_classes)

    def trunk(self, x):
        return self.layer3_p1(self.layer2(self.layer1(x)))


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
        self.drop = nn.Dropout(0.5)
        self.head = nn.Linear(ch, num_classes)

    def trunk(self, x):
        for s in self.stages:
            x = s(x)
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
