"""IRNet of the port: class-boundary (edge) and displacement-field heads
on a frozen VGG16 / M7 / ResNet50 trunk (counterpart of
``wsss_tpu/models/irn.py``; the reference's 03b_irn/net/vgg16_irn.py:7-229,
m7_irn.py:7-120, resnet50_irn.py:7-137).

The trunk runs in eval mode under ``torch.no_grad`` (the reference's
``.detach()`` at vgg16_irn.py:192-196; flax's ``stop_gradient`` with
``train=False``): ``IRNet.train()`` leaves it in eval mode, so only the
heads train.  Each head block is a 1x1 conv (no bias) -> GroupNorm (eps
1e-6, flax's default) -> bilinear upsample (``ops.filters
.resize_bilinear``) -> ReLU; a strided 1x1 conv pads nothing (flax SAME).

Grids: VGG16 and ResNet50 — edge and disp both on the /4 grid.  M7 — edge
on /2, disp on /4 (both later resized onto the CAM grid by the random
walk step, make_sem_seg_labels.py:67-69).

Layout is the JAX package's: ``forward`` takes NHWC images and returns
``(edge logits [B,h,w,1], disp [B,h,w,2])`` NHWC, float32.  Module
attribute names are the flax names (``fc_edge1`` .. ``fc_dp7b``).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from wsss_tpu_torch.models.backbones import M7_CFG, VGG16Backbone, VGGStage
from wsss_tpu_torch.models.resnet50 import ResNet50
from wsss_tpu_torch.ops.filters import resize_bilinear


def _up(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear x``factor`` upsample of NCHW ``x``."""
    if factor == 1:
        return x
    h, w = x.shape[2:]
    return resize_bilinear(x.permute(0, 2, 3, 1),
                           (h * factor, w * factor)).permute(0, 3, 1, 2)


class _GNConv(nn.Module):
    """1x1 conv (no bias) -> GroupNorm -> upsample -> ReLU, the unit of
    every IRN head block (vgg16_irn.py:31-99).  ``conv`` / ``gn`` are the
    flax ``Conv_0`` / ``GroupNorm_0``."""

    def __init__(self, in_ch: int, width: int, groups: int, stride: int = 1,
                 up: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, width, 1, stride=stride, bias=False)
        self.gn = nn.GroupNorm(groups, width, eps=1e-6)
        self.up = up

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(_up(self.gn(self.conv(x)), self.up))


def _crop_cat(maps):
    """NCHW maps cropped to the smallest and joined along channels."""
    h = min(m.shape[2] for m in maps)
    w = min(m.shape[3] for m in maps)
    return torch.cat([m[:, :, :h, :w] for m in maps], dim=1)


class M7Stages(nn.Module):
    """M7 trunk as IRNet stages (m7_irn.py:19-22): stage1 = layer1 (incl.
    pool, /2), stage2 = layer2 (/4), stage3 = layer3_p1 + 2x2 pool (/8)."""

    def __init__(self):
        super().__init__()
        self.layer1 = VGGStage(M7_CFG[0], 3)
        self.layer2 = VGGStage(M7_CFG[1], self.layer1.out_ch)
        self.layer3_p1 = VGGStage(M7_CFG[2], self.layer2.out_ch)
        self.pool = nn.MaxPool2d(2, 2)              # layer3_p2's 'M'

    def forward(self, x: torch.Tensor):
        s1 = self.layer1(x)
        s2 = self.layer2(s1)
        return [s1, s2, self.pool(self.layer3_p1(s2))]


# (flax name, input stage or earlier head, out width, groups, stride, up)
# per backbone; the head's last 1x1 conv is listed in _LAST
_HEADS = {
    'vgg16': (('fc_edge1', 0, 32, 4, 2, 1), ('fc_edge2', 1, 32, 4, 1, 1),
              ('fc_edge3', 2, 32, 4, 1, 2), ('fc_edge4', 3, 32, 4, 1, 2),
              ('fc_edge5', 4, 32, 4, 1, 2),
              ('fc_dp1', 0, 64, 8, 2, 1), ('fc_dp2', 1, 128, 16, 1, 1),
              ('fc_dp3', 2, 256, 16, 1, 1), ('fc_dp4', 3, 256, 16, 1, 1),
              ('fc_dp5', 4, 256, 16, 1, 1)),
    'resnet50': (('fc_edge1', 0, 32, 4, 1, 1), ('fc_edge2', 1, 32, 4, 1, 1),
                 ('fc_edge3', 2, 32, 4, 1, 2), ('fc_edge4', 3, 32, 4, 1, 4),
                 ('fc_edge5', 4, 32, 4, 1, 4),
                 ('fc_dp1', 0, 64, 8, 1, 1), ('fc_dp2', 1, 128, 16, 1, 1),
                 ('fc_dp3', 2, 256, 16, 1, 1), ('fc_dp4', 3, 256, 16, 1, 2),
                 ('fc_dp5', 4, 256, 16, 1, 2)),
    'm7': (('fc_edge1', 0, 32, 4, 1, 1), ('fc_edge2', 1, 32, 4, 1, 2),
           ('fc_edge3', 2, 32, 4, 1, 4),
           ('fc_dp1', 0, 64, 8, 2, 1), ('fc_dp2', 1, 128, 16, 1, 1),
           ('fc_dp3', 2, 256, 16, 1, 1)),
}
_LAST = {'vgg16': ('fc_edge6', 'fc_dp6', 'fc_dp7a', 'fc_dp7b'),
         'resnet50': ('fc_edge6', 'fc_dp6', 'fc_dp7a', 'fc_dp7b'),
         'm7': ('fc_edge4', 'fc_dp4', 'fc_dp5a', 'fc_dp5b')}


class IRNet(nn.Module):
    """Edge + displacement net on a frozen trunk ('vgg16' | 'resnet50' |
    'm7'); ``forward(x)`` -> (edge logits, disp), NHWC
    (vgg16_irn.py:192-196, 216-223)."""

    def __init__(self, backbone: str = 'vgg16'):
        super().__init__()
        if backbone == 'vgg16':
            self.trunk = VGG16Backbone()
            chans = [s.out_ch for s in self.trunk.stages]
        elif backbone == 'resnet50':
            # resnet50_irn.py:7-137: stem /4 (64 ch), layer1 /4 (256),
            # layer2 /8 (512), layer3 /16 (1024), layer4 /16 (2048)
            self.trunk = ResNet50(strides=(2, 2, 2, 1),
                                  dilations=(1, 1, 1, 1))
            chans = [64, 256, 512, 1024, 2048]
        elif backbone == 'm7':
            self.trunk = M7Stages()
            chans = [self.trunk.layer1.out_ch, self.trunk.layer2.out_ch,
                     self.trunk.layer3_p1.out_ch]
        else:
            raise ValueError(f'unknown backbone {backbone!r}')
        self.backbone = backbone
        self._plan = []
        for name, src, width, groups, stride, up in _HEADS[backbone]:
            setattr(self, name, _GNConv(chans[src], width, groups, stride,
                                        up))
            self._plan.append((name, src))
        edge_last, dp_up, dp_a, dp_b = _LAST[backbone]
        n_edge = sum(n.startswith('fc_edge') for n, _ in self._plan)
        setattr(self, edge_last, nn.Conv2d(32 * n_edge, 1, 1))
        setattr(self, dp_up, _GNConv(256 if backbone == 'm7' else 768, 256,
                                     16, up=2))
        setattr(self, dp_a, _GNConv(64 + 128 + 256, 256, 16))
        setattr(self, dp_b, nn.Conv2d(256, 2, 1, bias=False))
        self._last = (edge_last, dp_up, dp_a, dp_b)
        self.trunk.eval()

    def train(self, mode: bool = True):
        """Heads follow ``mode``; the trunk stays in eval mode."""
        super().train(mode)
        self.trunk.eval()
        return self

    def forward(self, x: torch.Tensor):
        with torch.no_grad():
            feats = self.trunk(x.permute(0, 3, 1, 2))
        out = {name: getattr(self, name)(feats[src])
               for name, src in self._plan}
        edge_last, dp_up, dp_a, dp_b = self._last
        edges = [v for k, v in out.items() if k.startswith('fc_edge')]
        edge = getattr(self, edge_last)(_crop_cat(edges))
        if self.backbone == 'm7':
            up3 = getattr(self, dp_up)(out['fc_dp3'])
        else:
            up3 = getattr(self, dp_up)(_crop_cat(
                [out['fc_dp3'], out['fc_dp4'], out['fc_dp5']]))
        h = getattr(self, dp_a)(_crop_cat([out['fc_dp1'], out['fc_dp2'],
                                           up3]))
        disp = getattr(self, dp_b)(h)
        return (edge.permute(0, 2, 3, 1).to(torch.float32),
                disp.permute(0, 2, 3, 1).to(torch.float32))


@torch.no_grad()
def edge_displacement_inference(net, img: torch.Tensor, disp_mean=None):
    """EdgeDisplacement-style inference (vgg16_irn.py:303-321).

    Runs ``net`` (an IRNet) on image + horizontal flip, merges the edge
    logits (sigmoid(e/2 + flip(e')/2)) and mean-shifts the displacement
    field by the calibrated ``disp_mean`` (train_irn.py:152-165).
    img: [1, H, W, 3] normalized, on net's device.  Returns (edge [h,w],
    disp [h,w,2])."""
    edge, disp = net(torch.cat([img, img.flip(2)]))
    edge = torch.sigmoid(edge[0, ..., 0] / 2. + edge[1].flip(1)[..., 0] / 2.)
    disp = disp[0]
    if disp_mean is not None:
        disp = disp - torch.as_tensor(disp_mean, dtype=torch.float32,
                                      device=disp.device)[None, None, :]
    return edge, disp
