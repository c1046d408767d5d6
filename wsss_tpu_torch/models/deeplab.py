"""DeepLab-LargeFOV / ASPP networks of SEC and DSRG (counterpart of
``wsss_tpu/models/deeplab.py``).

Trunk: conv1..conv5 of VGG16 (conv -> ReLU, no BatchNorm), conv5 with
dilation 2; 3x3 max-pools with stride 2 after stages 1-3 and stride 1
after stages 4-5; then pool5a, a 3x3 stride-1 average pool.  Head: fc6
(3x3 atrous, 1024) -> fc7 (1x1, 1024) -> fc8 (1x1, classes), each hidden
layer followed by ReLU and dropout.  SEC has one head at rate 12, DSRG
four at rates 6/12/18/24, summed.  A 321^2 input gives a 41^2 map.

Padding follows flax's 'SAME': a stride-2 3x3 pool pads (1, 1) on an odd
axis (321 -> 161 -> 81 -> 41) but (0, 1) on an even one, with -inf for
the max; the average pool pads zeros and divides by the full window of 9
at the border too; a dilated 3x3 convolution pads by its dilation.

Public layout is the JAX package's: NHWC in, NHWC float32 logits out;
the convolutions run on the NCHW view of the same memory; fc6's forward
runs as explicit float32 products (``atrous_conv``), its backward as the
convolution's own.  In train mode (``net.train()``) drop6 and drop7 draw
their masks from the ``generator`` the forward is given
(``backbones.Dropout``); in eval mode they are the identity.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from wsss_tpu_torch.models.backbones import Dropout
from wsss_tpu_torch.utils.timing import span

MIN_PROB = 1e-4  # SEC.py:40

# calls of ``atrous_conv``: one a LargeFOV head's forward
ATROUS_CALLS = 0

# (n_convs, width, pool_stride, dilation) per trunk stage
TRUNK_CFG = ((2, 64, 2, 1), (2, 128, 2, 1), (3, 256, 2, 1),
             (3, 512, 1, 1), (3, 512, 1, 2))


def _same_pad(n: int, window: int, stride: int):
    """flax/XLA 'SAME' padding (lo, hi) of one axis of length n."""
    total = max((-(-n // stride) - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(..., padding='SAME')`` of flax on NCHW."""
    ph, pw = (_same_pad(n, window, stride) for n in x.shape[-2:])
    x = F.pad(x, pw + ph, value=float('-inf'))
    return F.max_pool2d(x, window, stride)


class DeepLabTrunk(nn.Module):
    """conv1..conv5 and pool5a on NCHW tensors; ``convs[s][i]`` is the
    flax trunk's ``conv{s+1}_{i+1}``."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList()
        ch = 3
        for n, width, _, dil in TRUNK_CFG:
            stage = nn.ModuleList()
            for _ in range(n):
                stage.append(nn.Conv2d(ch, width, 3, padding=dil,
                                       dilation=dil))
                ch = width
            self.convs.append(stage)
        self.out_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage, (_, _, pool_stride, _) in zip(self.convs, TRUNK_CFG):
            for conv in stage:
                x = torch.relu(conv(x))
            x = max_pool_same(x, 3, pool_stride)
        # pool5a: zero padding counted in the divisor, as flax's avg_pool
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class _AtrousConv(torch.autograd.Function):
    """A 3x3 convolution at dilation r, padding r, stride 1, on NCHW ``x``.

    Forward: the NHWC map zero-padded by r, its nine taps a pixel laid
    out in the kernel's own (c, kh, kw) order as a column matrix
    [H*W, 9*C] an image (one strided copy), times the kernel's
    [out, 9*C] view, plus the bias in the product's epilogue: one float32
    ``addmm`` an image, so an image's output is the same bits alone or in
    any batch.  Summed in that order, from zero, then the bias added, the
    product gives cuDNN's float32 convolution bit for bit on an H100 (its
    direct kernel at batch 8 and its implicit GEMM at batch 1).  The
    columns are transient.  Backward: ``aten::convolution_backward``, the
    call autograd makes for ``F.conv2d``."""

    @staticmethod
    def forward(ctx, x, weight, bias, rate):
        ctx.save_for_backward(x, weight)
        ctx.rate = rate
        b, c, h, w = x.shape
        xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, rate, rate, rate, rate))
        taps = (xp.unfold(1, 2 * rate + 1, 1)[..., ::rate]
                .unfold(2, 2 * rate + 1, 1)[..., ::rate])  # [b,h,w,c,3,3]
        cols = taps.reshape(b, h * w, 9 * c)
        kernel = weight.reshape(weight.shape[0], 9 * c)
        out = x.new_empty(b, h * w, weight.shape[0])
        for n in range(b):
            torch.addmm(bias, cols[n], kernel.t(), out=out[n])
        return out.view(b, h, w, -1).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        r = ctx.rate
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad, x, weight, [weight.shape[0]], [1, 1], [r, r], [r, r],
            False, [0, 0], 1, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


def atrous_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv(x)`` for a 3x3 ``nn.Conv2d`` with padding = dilation, as
    ``_AtrousConv``'s explicit products (for fc6 at batch 8 cuDNN picks a
    direct kernel ~48x slower on an H100)."""
    global ATROUS_CALLS
    ATROUS_CALLS += 1
    with span('wsss.net.atrous'):
        return _AtrousConv.apply(x, conv.weight, conv.bias,
                                 conv.dilation[0])


class LargeFOVHead(nn.Module):
    """fc6 (3x3 atrous, 1024) -> fc7 (1x1, 1024) -> fc8 (1x1, C)."""

    def __init__(self, num_classes: int, dilation: int = 12,
                 in_ch: int = 512):
        super().__init__()
        self.fc6 = nn.Conv2d(in_ch, 1024, 3, padding=dilation,
                             dilation=dilation)
        self.fc7 = nn.Conv2d(1024, 1024, 1)
        self.fc8 = nn.Conv2d(1024, num_classes, 1)
        self.drop6 = Dropout(0.5)
        self.drop7 = Dropout(0.5)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.drop6(torch.relu(atrous_conv(x, self.fc6)), generator)
        x = self.drop7(torch.relu(self.fc7(x)), generator)
        return self.fc8(x)


class SECNet(nn.Module):
    """DeepLab-LargeFOV FCN of SEC: NHWC images -> NHWC logits."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.trunk = DeepLabTrunk()
        self.head = LargeFOVHead(num_classes, in_ch=self.trunk.out_ch)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.head(self.trunk(x.permute(0, 3, 1, 2)), generator)
        return x.permute(0, 2, 3, 1).to(torch.float32)


class DSRGNet(nn.Module):
    """DeepLab-ASPP FCN of DSRG: four LargeFOV branches at dilation
    6/12/18/24 (``branches[i]`` is flax's ``branch{rate}``), summed."""

    def __init__(self, num_classes: int,
                 rates: Sequence[int] = (6, 12, 18, 24)):
        super().__init__()
        self.rates = tuple(rates)
        self.trunk = DeepLabTrunk()
        self.branches = nn.ModuleList(
            LargeFOVHead(num_classes, dilation=r, in_ch=self.trunk.out_ch)
            for r in self.rates)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.trunk(x.permute(0, 3, 1, 2))
        out = 0.
        for branch in self.branches:
            out = out + branch(x, generator)
        return out.permute(0, 2, 3, 1).to(torch.float32)


def sp_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax with the min_prob floor, renormalized (SEC.py:232-250)."""
    sm = torch.softmax(logits, dim=-1) + MIN_PROB
    return sm / torch.sum(sm, dim=-1, keepdim=True)
