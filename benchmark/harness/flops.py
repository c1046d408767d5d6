"""The arithmetic the configurations' FLOP files share."""
from __future__ import annotations

import math


def macs(shape, pixels: int) -> int:
    """Multiply-adds of a conv or dense kernel of ``shape`` applied at
    ``pixels`` output positions."""
    return math.prod(shape) * pixels


def kernel_shapes(layers: dict) -> dict:
    """{network: [kernel shape, ...]} of ``layers``' (shape, pixels)."""
    return {n: [s for s, _ in ls] for n, ls in layers.items()}
