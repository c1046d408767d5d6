"""The weights of a run, made by the benchmark from the seed on the device
and handed to the program and to the reference alike.

One ``torch.randn`` call on the card fills every kernel and bias of a
network: conv and dense kernels He-normal (std sqrt(2 / fan_in)), clamped
at two standard deviations, so activations keep their scale through a
deep ReLU stack and random scores spread around the thresholds as
trained ones do; biases N(0, BIAS_STD).  BatchNorm keeps scale 1, bias
0, running mean 0 and variance 1."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

BIAS_STD = 0.05

Layer = Tuple[torch.Tensor, torch.Tensor]     # (kernel, bias)


@torch.no_grad()
def make_layers(shapes: Sequence[Tuple[int, ...]], seed: int,
                device) -> List[Layer]:
    """(kernel, bias) of each kernel shape [out, in, (kh, kw)] in
    ``shapes``, drawn from ``seed`` in one call on ``device``."""
    sizes = []
    for s in shapes:
        sizes += [math.prod(s), s[0]]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, o = [], 0
    for s in shapes:
        n = math.prod(s)
        std = math.sqrt(2.0 / math.prod(s[1:]))
        w = (flat[o:o + n].view(s) * std).clamp_(-2 * std, 2 * std)
        o += n
        b = flat[o:o + s[0]] * BIAS_STD
        o += s[0]
        out.append((w.contiguous(), b.contiguous()))
    return out


def kernel_modules(module: nn.Module) -> List[nn.Module]:
    """The module's conv and dense layers in definition order."""
    return [m for m in module.modules()
            if isinstance(m, (nn.Conv2d, nn.Linear))]


@torch.no_grad()
def load_into(module: nn.Module, layers: Sequence[Layer]) -> None:
    """Copy ``layers`` into ``module``'s conv and dense layers, in order;
    a count or shape that differs raises (the program and the
    configuration disagree)."""
    mods = kernel_modules(module)
    if len(mods) != len(layers):
        raise ValueError(f'{len(mods)} kernel layers in the program, '
                         f'{len(layers)} in the configuration')
    for m, (w, b) in zip(mods, layers):
        if tuple(m.weight.shape) != tuple(w.shape):
            raise ValueError(f'program layer {tuple(m.weight.shape)} vs '
                             f'configuration {tuple(w.shape)}')
        m.weight.copy_(w)
        m.bias.copy_(b)
