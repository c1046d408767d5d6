"""The comparisons that decide ``correct``, and the byte count of the
grid filter's calls."""
from __future__ import annotations

from typing import Dict, List

import torch


def max_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp(min=1e-30))


def leaf_norm_gap(got: List[torch.Tensor], ref: List[torch.Tensor],
                  skip: List[bool] = None) -> float:
    """The worst leaf's | |got| - |ref| | over the larger of |ref| and the
    median leaf's |ref| (leaves marked in ``skip`` left out)."""
    gn = [float(torch.linalg.vector_norm(g.double())) for g in got]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = float(torch.tensor(rn).median())
    keep = [i for i in range(len(rn)) if not (skip and skip[i])]
    return max(abs(gn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in keep)


def grid_filter_counter(counters: Dict[str, float]):
    """An observer of ``MXUBilateralGrid.filter``: the bytes a filter
    must move (its input [B, H, W, C] read once, its float32 RGB guide
    read once, its output written once) and the calls."""
    def observe(args, kwargs, out):
        grid, x = args[0], args[1]
        b, h, w = grid.bhw
        counters['grid.filter_bytes'] += 4 * (x.numel() + out.numel()
                                              + 3 * b * h * w)
        counters['grid.filter_calls'] += 1
    return observe
