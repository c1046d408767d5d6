"""The precision the reference computes in.

'fp32' is the configurations' numerics: float32 with TF32 off on the
card.  'tf32' is the control, the nearest precision below: on the card
cuDNN and cuBLAS run TF32; on the CPU, which has no TF32, the operands of
every convolution and product are rounded to TF32's 10-bit mantissa (the
rounding TF32 applies before its float32 sums), the gradient passing
straight through."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (nearest, ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Numerics:
    """A context that pins the card's TF32 switches for the reference and
    provides its convolutions and products."""

    def __init__(self, mode: str, device):
        if mode not in ('fp32', 'tf32'):
            raise ValueError(mode)
        self.mode = mode
        self.device = torch.device(device)
        self.emulate = mode == 'tf32' and self.device.type == 'cpu'
        self._saved = None

    def __enter__(self):
        if self.device.type == 'cuda':
            self._saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            on = self.mode == 'tf32'
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self._saved
            self._saved = None

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if not self.emulate:
            return x
        return x + (tf32_round(x.detach()) - x.detach())

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.r(x), self.r(w), b, **kw)

    def linear(self, x, w, b=None):
        return F.linear(self.r(x), self.r(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.r(a), self.r(b))

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))
