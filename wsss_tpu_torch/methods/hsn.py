"""HistoSegNet inference for VOC2012 and DeepGlobe (counterpart of
``wsss_tpu/methods/hsn.py`` ``HSNSegmenter``).

Confidence-scaled Grad-CAM -> fg/bg merge -> dense CRF -> argmax.
Quirks of the reference kept:
  * the pass threshold is the constant 1/3 (03c_hsn/demo.py:83);
  * VOC's bg channel is 0.15 * sigmoid(max(X_bg) - X_bg), X_bg the sum of
    the bg net's CAMs, the max taken over the whole batch passed in;
  * DeepGlobe drops the classifier's last class (drop_last_class).
The mesh and ADP paths of the reference are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle, _normalizer
from wsss_tpu_torch.ops import gradcam as gc_ops
from wsss_tpu_torch.ops.crf import config as crf_config
from wsss_tpu_torch.ops.crf.meanfield import mean_field
from wsss_tpu_torch.utils.device import resolve_device

HSN_THRESHOLD = 1.0 / 3.0


class HSNSegmenter:
    """VOC2012 / DeepGlobe HistoSegNet inference on one device; the
    handles must live on that device."""

    def __init__(self, spec: registry.DatasetSpec, fg: _ClassifierHandle,
                 bg: Optional[_ClassifierHandle] = None,
                 model_type: str = 'VGG16',
                 cfg: Optional[crf_config.CRFConfig] = None,
                 drop_last_class: bool = False, device='cuda'):
        self.device = resolve_device(device)
        for h in (fg, bg):
            if h is not None and h.device != self.device:
                raise ValueError(f'handle on {h.device}, segmenter on '
                                 f'{self.device}')
        if spec.uses_bg_net and bg is None:
            raise ValueError(f'{spec.name} needs a background network')
        self.spec = spec
        self.fg, self.bg = fg, bg
        self.drop_last_class = drop_last_class
        self.cfg = cfg or crf_config.hsn_config(spec.name, model_type)
        self._norm = _normalizer(spec.norm_cues, self.device)

    def _cams(self, handle: _ClassifierHandle, x: torch.Tensor):
        scores, feats = handle.model(x)
        size = handle.input_size
        return gc_ops.grad_cam_confidence(
            feats, handle.weights, scores >= HSN_THRESHOLD, scores,
            upsample_hw=(size, size))

    @torch.no_grad()
    def probs(self, imgs: torch.Tensor) -> torch.Tensor:
        """CAM stage: f32 RGB images [B,S,S,3] 0..255 on the device ->
        CRF unaries [B,S,S,C]."""
        x = self._norm(imgs)
        h_fg = self._cams(self.fg, x)
        if self.spec.uses_bg_net:
            x_bg = torch.sum(self._cams(self.bg, x), dim=-1)
            bg_ch = 0.15 * torch.sigmoid(torch.amax(x_bg) - x_bg)
            return torch.cat([bg_ch[..., None], h_fg], dim=-1)
        if self.drop_last_class:
            return h_fg[..., :-1]
        return h_fg

    @torch.no_grad()
    def segment_batch(self, imgs_raw) -> torch.Tensor:
        """imgs_raw: [B,S,S,3] RGB 0..255, uint8 or float, numpy or a
        tensor -> labels [B,S,S] int32 on the device."""
        imgs = torch.as_tensor(imgs_raw).to(self.device, torch.float32)
        probs = self.probs(imgs)
        q = mean_field(probs, imgs, self.cfg)
        return torch.argmax(q, dim=-1).to(torch.int32)
