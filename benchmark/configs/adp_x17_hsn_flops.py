"""The work of ``adp_x17_hsn``, from its file's shapes.

  * ``forward_macs``: every conv and dense layer of the X1.7 classifier
    at the input size (the M7 trunk, then the 51-way head after the
    global max); an image's forward is 2 x these multiply-adds.  The CRF
    counts 0 here, as in the other configurations.
  * ``window_flops``: the least work any implementation of the two CRFs'
    direct windows must do for an image: 2 C FLOPs (a multiply and an
    add) per offset, pixel and filter of C channels, plus 11 for each
    colour weight (3 differences, 3 squares, 2 adds, the scale, the exp
    and the spatial weight), computed once per CRF.  A CRF filters its
    normalizer (C 1) once and its messages (C of its classes) once an
    iteration.  K, the window's offsets, is counted here: the integer
    (dy, dx) with dy^2 + dx^2 <= (radius_sxy * bi_sxy)^2."""
from __future__ import annotations

import math

from benchmark.harness import flops

COLOUR_WEIGHT_FLOPS = 11


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
        ls.append(((classes, ch), 1))     # the head, after the global max
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


def window_offsets(sxy: float, radius_sxy: float) -> int:
    """K: the integer offsets within radius_sxy * sxy of the centre."""
    r = radius_sxy * sxy
    n = int(math.ceil(r))
    return sum(1 for dy in range(-n, n + 1) for dx in range(-n, n + 1)
               if dy * dy + dx * dx <= r * r)


def crf_channels(cfg: dict) -> dict:
    """{CRF: classes} of the two CRFs' unaries."""
    return {'crf_morph': 1 + len(cfg['morph_classes']),
            'crf_func': 2 + len(cfg['func_classes'])}


def window_flops(cfg: dict) -> int:
    """The two windows' FLOPs for one image at the input size."""
    px = cfg['input_size'] ** 2
    total = 0
    for key, c in crf_channels(cfg).items():
        crf = cfg[key]
        k = window_offsets(crf['bi_sxy'], cfg['window']['radius_sxy'])
        per_offset_px = (2 * 1 + 2 * c * crf['iterations']
                         + COLOUR_WEIGHT_FLOPS)
        total += k * px * per_offset_px
    return total
