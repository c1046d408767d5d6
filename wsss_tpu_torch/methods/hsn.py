"""HistoSegNet inference (counterpart of ``wsss_tpu/methods/hsn.py``
``HSNSegmenter`` and ``ADPHSNSegmenter``).

Confidence-scaled Grad-CAM -> fg/bg merge (VOC/DeepGlobe) or HTT-adjust
+ class-specific Grad-CAM (ADP) -> dense CRF -> argmax.
Quirks of the reference kept:
  * the pass threshold is the constant 1/3 (03c_hsn/demo.py:83);
  * VOC's bg channel is 0.15 * sigmoid(max(X_bg) - X_bg), X_bg the sum of
    the bg net's CAMs, the max taken over the whole batch passed in;
  * DeepGlobe drops the classifier's last class (drop_last_class).
The mesh path of the reference is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle, _normalizer
from wsss_tpu_torch.ops import cues as cue_ops
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


class ADPHSNSegmenter:
    """ADP morph + func HistoSegNet inference on one device (segment_adp,
    03c_hsn/demo.py:271-464): modify_by_htt -> CS-Grad-CAM -> CRF.

    handle: the ADP classifier, 'X1.7' (51-way; its 31 valid classes are
    picked through ``x17_to_31``) or 'VGG16' (31-way), with its
    calibrated thresholds."""

    def __init__(self, handle: _ClassifierHandle, model_family: str,
                 cfg_morph: Optional[crf_config.CRFConfig] = None,
                 cfg_func: Optional[crf_config.CRFConfig] = None,
                 device='cuda'):
        self.device = resolve_device(device)
        if handle.device != self.device:
            raise ValueError(f'handle on {handle.device}, segmenter on '
                             f'{self.device}')
        self.handle = handle
        maps = registry.adp_index_maps(model_family)
        self.morph_spec = registry.get('ADP-morph')
        self.func_spec = registry.get('ADP-func')
        self.cfg_morph = cfg_morph or crf_config.hsn_config('ADP-morph')
        self.cfg_func = cfg_func or crf_config.hsn_config('ADP-func')
        self._norm = _normalizer(self.morph_spec.norm_cues, self.device)
        is_x17 = model_family.upper().startswith('X1')
        base = registry.ADP_CLASSES_VGG16

        def among(names):
            return np.array([i for i, c in enumerate(base) if c in names])

        def index(a):
            return torch.as_tensor(a, dtype=torch.long, device=self.device)

        morph31 = among(registry.ADP_MORPH_CLASSES)
        adipose31 = among(registry.ADP_ADIPOSE_CLASSES)
        self._all31 = index(maps['x17_to_31'] if is_x17 else maps['all'])
        self._morph31 = index(morph31)
        self._func31 = index(among(registry.ADP_FUNC_CLASSES))
        self._adipose_in_morph = [
            int(i) for i in 1 + np.searchsorted(morph31, adipose31)]
        self._func_exc = [self.func_spec.seg_class_names.index(c)
                          for c in registry.ADP_BG_EXCEPTION['func']]

    @torch.no_grad()
    def probs(self, imgs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """CAM stage: f32 RGB images [B,S,S,3] 0..255 on the device -> the
        class-specific CAMs (morph [B,S,S,29], func [B,S,S,5]) that are
        the CRFs' unaries."""
        h = self.handle
        size = h.input_size
        scores, feats = h.model(self._norm(imgs))
        cams = gc_ops.grad_cam_confidence(
            feats, h.weights, scores >= h.thresholds[None], scores,
            upsample_hw=(size, size))
        cams31 = cams[..., self._all31]
        morph = cams31.new_zeros(cams31.shape[:3]
                                 + (self.morph_spec.n_seg_classes,))
        morph[..., 1:] = cams31[..., self._morph31]
        morph = cue_ops.modify_by_htt(
            morph, imgs, exception_inds=self._adipose_in_morph, bg_ind=0)
        func = cams31.new_zeros(cams31.shape[:3]
                                + (self.func_spec.n_seg_classes,))
        func[..., 2:] = cams31[..., self._func31]
        adipose_cam = torch.amax(morph[..., self._adipose_in_morph], dim=-1)
        func = cue_ops.modify_by_htt(
            func, imgs, exception_inds=self._func_exc, bg_ind=0,
            other_ind=1, adipose_cam=adipose_cam)
        return gc_ops.cs_gradcam(morph), gc_ops.cs_gradcam(func, other_ind=1)

    @torch.no_grad()
    def segment_batch(self, imgs_raw) -> Tuple[torch.Tensor, torch.Tensor]:
        """imgs_raw: [B,S,S,3] RGB 0..255, uint8 or float, numpy or a
        tensor -> (morph, func) labels, each [B,S,S] int32 on the
        device."""
        imgs = torch.as_tensor(imgs_raw).to(self.device, torch.float32)
        cs_m, cs_f = self.probs(imgs)
        q_m = mean_field(cs_m, imgs, self.cfg_morph)
        q_f = mean_field(cs_f, imgs, self.cfg_func)
        return (torch.argmax(q_m, dim=-1).to(torch.int32),
                torch.argmax(q_f, dim=-1).to(torch.int32))
