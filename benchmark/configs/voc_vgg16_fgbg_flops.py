"""The work of ``voc_vgg16_fgbg``, from its file's shapes: every conv and
dense layer of the fg and bg classifiers at the input size.  An image's
forward is 2 x the multiply-adds of those layers; the CRF counts 0, so
the count is the same whatever implements the work."""
from __future__ import annotations

from benchmark.harness import flops


def layers(cfg: dict) -> dict:
    """{network: [(kernel shape, output pixels), ...]} in layer order."""
    out = {}
    for name, classes in cfg['networks'].items():
        ls, ch, side = [], 3, cfg['input_size']
        for stage in cfg['stages']:
            for v in stage:
                if v == 'M':
                    side //= 2            # 2x2 max-pool, floor
                elif v != 'D':
                    ls.append(((v, ch, 3, 3), side * side))
                    ch = v
        ls.append(((classes, ch), 1))     # the head, after mean pooling
        out[name] = ls
    return out


def kernel_shapes(cfg: dict) -> dict:
    return flops.kernel_shapes(layers(cfg))


def forward_macs(cfg: dict) -> dict:
    conv = lin = 0
    for ls in layers(cfg).values():
        for shape, px in ls:
            if len(shape) == 4:
                conv += flops.macs(shape, px)
            else:
                lin += flops.macs(shape, px)
    return {'conv': conv, 'linear': lin, 'total': conv + lin}
