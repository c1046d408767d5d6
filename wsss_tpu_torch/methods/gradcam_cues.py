"""Classifier handles of the port (counterpart of
``wsss_tpu/methods/gradcam_cues.py`` ``_normalizer`` and
``_ClassifierHandle``): a classifier, its calibrated thresholds and its
static Grad-CAM weights, on one device."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from wsss_tpu_torch.io.flax_bridge import load_flax_variables
from wsss_tpu_torch.models.backbones import build_classifier, init_random
from wsss_tpu_torch.ops import gradcam as gc_ops
from wsss_tpu_torch.utils.device import resolve_device


def _normalizer(norm, device):
    """``((img * scale - mean) / std) * post_scale`` on [..., 3] RGB."""
    mean = torch.as_tensor(norm.mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(norm.std, dtype=torch.float32, device=device)

    def f(img):
        return ((img * norm.scale - mean) / std) * norm.post_scale
    return f


class _ClassifierHandle:
    """A classifier in eval mode on ``device`` with its thresholds [C] and
    its Grad-CAM weights [F, C] (from a zero image, pooled by the model's
    own head: mean for VGG16, max for M7)."""

    def __init__(self, model: torch.nn.Module, thresholds, input_size: int,
                 device='cuda'):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.thresholds = torch.as_tensor(
            np.array(thresholds, np.float32).reshape(-1),
            device=self.device)
        self.input_size = input_size

        def head_fn(feats):
            return model.head(model.pool_feats(feats))

        self.weights = gc_ops.gradcam_weights(
            model.features, head_fn, (input_size, input_size), self.device)

    @classmethod
    def random(cls, model_type: str, num_classes: int, input_size: int,
               seed: int = 0, device='cuda'):
        """Untrained handle: flax-style random init drawn from a seeded
        torch.Generator, flat thresholds of 0.5."""
        model = build_classifier(model_type, num_classes)
        init_random(model, torch.Generator().manual_seed(seed))
        return cls(model, np.full(num_classes, 0.5, np.float32), input_size,
                   device=device)

    @classmethod
    def from_flax(cls, model_type: str, numpy_variables: Mapping,
                  thresholds, input_size: int, device='cuda'):
        """Handle carrying the JAX package's flax variables (numpy leaves)
        across through ``io.flax_bridge``."""
        num_classes = np.shape(numpy_variables['params']['head']['bias'])[0]
        model = load_flax_variables(
            build_classifier(model_type, num_classes), numpy_variables)
        return cls(model, thresholds, input_size, device=device)
