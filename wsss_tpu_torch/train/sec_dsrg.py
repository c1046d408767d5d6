"""SEC / DSRG network holder (counterpart of the predict half of
``wsss_tpu/train/sec_dsrg.py`` ``SECDSRGTrainer``: ``__init__`` :84-93
and ``predict_logits`` :130-131).  The optimizer, the losses and the
train step are not ported yet."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from wsss_tpu_torch.io.flax_bridge import load_flax_deeplab
from wsss_tpu_torch.models.backbones import init_random
from wsss_tpu_torch.models.deeplab import DSRGNet, SECNet
from wsss_tpu_torch.utils.device import resolve_device


class SECDSRGPredictor:
    """A SECNet ('SEC') or DSRGNet ('DSRG') in eval mode on ``device``.
    Its weights are flax's default initialisation drawn from a
    torch.Generator seeded with ``seed`` until ``from_flax`` replaces
    them."""

    def __init__(self, method: str, num_classes: int, device='cuda',
                 seed: int = 0):
        self.device = resolve_device(device)
        method = method.upper()
        if method == 'SEC':
            net = SECNet(num_classes)
        elif method == 'DSRG':
            net = DSRGNet(num_classes)
        else:
            raise ValueError(method)
        self.method = method
        self.num_classes = num_classes
        init_random(net, torch.Generator().manual_seed(seed))
        self.net = net.to(self.device).eval()

    @classmethod
    def random(cls, method: str, num_classes: int, seed: int = 0,
               device='cuda'):
        """Untrained predictor with weights drawn from ``seed``."""
        return cls(method, num_classes, device=device, seed=seed)

    @classmethod
    def from_flax(cls, method: str, numpy_params: Mapping, device='cuda'):
        """Predictor carrying the JAX package's flax ``params`` tree
        (numpy leaves) across through ``io.flax_bridge``."""
        head = 'head' if method.upper() == 'SEC' else 'branch6'
        num_classes = np.shape(numpy_params[head]['fc8']['bias'])[0]
        self = cls(method, num_classes, device=device)
        load_flax_deeplab(self.net, numpy_params)
        return self

    @torch.no_grad()
    def predict_logits(self, imgs_norm: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC images -> NHWC logits on the /8 grid."""
        return self.net(imgs_norm.to(self.device, torch.float32))
