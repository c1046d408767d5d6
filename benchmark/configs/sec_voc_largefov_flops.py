"""The work of ``sec_voc_largefov``, from its file's shapes: every
convolution of DeepLab-LargeFOV at the input size (pools with 'SAME'
padding: ceil(n / stride)).  An image's forward is 2 x their
multiply-adds; a training image adds the backward's two products of each
layer (input and kernel gradients), less the first layer's input
gradient, which nothing needs.  The CRF counts 0."""
from __future__ import annotations

from benchmark.harness import flops


def layers(cfg: dict) -> dict:
    """{'fcn': [(kernel shape, output pixels), ...]} in layer order."""
    ls, ch, side = [], 3, cfg['input_size']
    for n, width, pool_stride, _ in cfg['trunk']:
        for _ in range(n):
            ls.append(((width, ch, 3, 3), side * side))
            ch = width
        side = -(-side // pool_stride)
    f = cfg['fc_width']
    px = side * side
    ls += [((f, ch, 3, 3), px), ((f, f, 1, 1), px),
           ((cfg['classes'], f, 1, 1), px)]
    return {'fcn': ls}


def kernel_shapes(cfg: dict) -> dict:
    return flops.kernel_shapes(layers(cfg))


def forward_macs(cfg: dict) -> dict:
    conv = sum(flops.macs(s, px) for s, px in layers(cfg)['fcn'])
    return {'conv': conv, 'linear': 0, 'total': conv}


def train_macs(cfg: dict) -> dict:
    ls = layers(cfg)['fcn']
    conv = 3 * sum(flops.macs(s, px) for s, px in ls) - flops.macs(*ls[0])
    return {'conv': conv, 'linear': 0, 'total': conv}
