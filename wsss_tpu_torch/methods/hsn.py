"""HistoSegNet inference (counterpart of ``wsss_tpu/methods/hsn.py``
``HSNSegmenter`` and ``ADPHSNSegmenter``).

Confidence-scaled Grad-CAM -> fg/bg merge (VOC/DeepGlobe) or HTT-adjust
+ class-specific Grad-CAM (ADP) -> dense CRF -> argmax.
Quirks of the reference kept:
  * the pass threshold is the constant 1/3 (03c_hsn/demo.py:83);
  * VOC's bg channel is 0.15 * sigmoid(max(X_bg) - X_bg), X_bg the sum of
    the bg net's CAMs, the max taken over the whole batch passed in;
  * DeepGlobe drops the classifier's last class (drop_last_class).

``segment_batch(imgs, mesh=)`` cuts the batch over the mesh's 'data' axis
(``parallel.mesh``), one replica of each classifier per distinct device.
Where the reference runs its fused per-shard step (the CRF takes the grid,
``_mxu_ok``, and no other mesh axis is larger than 1) every shard runs the
whole step on its images, so VOC's bg max is shard-local, as in the
reference's per-GPU processes; otherwise the max stays global over the
batch, as under the reference's GSPMD program.
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
from wsss_tpu_torch.ops.crf.meanfield import _mxu_ok, mean_field
from wsss_tpu_torch.parallel.mesh import map_shards, on_device, shard_batch
from wsss_tpu_torch.utils.device import resolve_device
from wsss_tpu_torch.utils.timing import span

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
        with span('wsss.cam'):
            scores, feats = handle.model(x)
            size = handle.input_size
            return gc_ops.grad_cam_confidence(
                feats, handle.weights, scores >= HSN_THRESHOLD, scores,
                upsample_hw=(size, size))

    def _on(self, device) -> 'HSNSegmenter':
        return on_device(self, device, lambda d: HSNSegmenter(
            self.spec, self.fg.to(d),
            None if self.bg is None else self.bg.to(d), cfg=self.cfg,
            drop_last_class=self.drop_last_class, device=d))

    def _fg_bg(self, imgs: torch.Tensor):
        """(fg CAMs [B,S,S,C_fg], X_bg [B,S,S] or None)."""
        x = self._norm(imgs)
        h_fg = self._cams(self.fg, x)
        if not self.spec.uses_bg_net:
            return h_fg, None
        return h_fg, torch.sum(self._cams(self.bg, x), dim=-1)

    def _merge(self, h_fg, x_bg, bg_max) -> torch.Tensor:
        if x_bg is not None:
            bg_ch = 0.15 * torch.sigmoid(bg_max - x_bg)
            return torch.cat([bg_ch[..., None], h_fg], dim=-1)
        if self.drop_last_class:
            return h_fg[..., :-1]
        return h_fg

    @torch.no_grad()
    def probs(self, imgs: torch.Tensor) -> torch.Tensor:
        """CAM stage: f32 RGB images [B,S,S,3] 0..255 on the device ->
        CRF unaries [B,S,S,C]."""
        h_fg, x_bg = self._fg_bg(imgs)
        return self._merge(h_fg, x_bg,
                           None if x_bg is None else torch.amax(x_bg))

    def _labels(self, probs, imgs) -> torch.Tensor:
        return torch.argmax(mean_field(probs, imgs, self.cfg),
                            dim=-1).to(torch.int32)

    def per_shard(self, mesh) -> bool:
        """Whether ``segment_batch(mesh=)`` runs the whole step per shard
        (bg max shard-local): the reference's fused-step rule."""
        n_ch = (self.spec.n_fg_classes + 1 if self.spec.uses_bg_net
                else self.spec.n_fg_classes - int(self.drop_last_class))
        size = self.fg.input_size
        extra = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                             if a != 'data']))
        return extra == 1 and _mxu_ok((size, size), n_ch, self.cfg)

    @torch.no_grad()
    def segment_batch(self, imgs_raw, mesh=None) -> torch.Tensor:
        """imgs_raw: [B,S,S,3] RGB 0..255, uint8 or float, numpy or a
        tensor (or placed on ``mesh`` by ``shard_batch``) -> labels
        [B,S,S] int32 on the device (the first shard's, with a mesh)."""
        with span('wsss.hsn.segment_batch'):
            if mesh is not None:
                return self._segment_mesh(imgs_raw, mesh)
            with span('wsss.io.to_device'):
                imgs = torch.as_tensor(imgs_raw).to(self.device,
                                                    torch.float32)
            return self._labels(self.probs(imgs), imgs)

    def _segment_mesh(self, imgs_raw, mesh) -> torch.Tensor:
        (imgs,), b0 = shard_batch(mesh, imgs_raw)
        if self.per_shard(mesh):
            return map_shards(mesh, lambda d, x: self._on(d).segment_batch(x),
                              imgs, b0=b0)
        devs = mesh.data_devices()
        xs = [p.to(torch.float32) for p in imgs.pieces]
        parts = [self._on(d)._fg_bg(x) for d, x in zip(devs, xs)]
        bg_max = None
        if self.spec.uses_bg_net:      # the batch-global max
            bg_max = torch.amax(torch.stack(
                [torch.amax(x_bg).to(devs[0]) for _, x_bg in parts]))

        def finish(d, x, part):
            bg = None if bg_max is None else bg_max.to(d)
            return self._labels(self._merge(*part, bg), x)
        return map_shards(mesh, finish, xs, parts, b0=b0)


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
        self.model_family = model_family
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
        with span('wsss.cam'):
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

    def _on(self, device) -> 'ADPHSNSegmenter':
        return on_device(self, device, lambda d: ADPHSNSegmenter(
            self.handle.to(d), self.model_family, cfg_morph=self.cfg_morph,
            cfg_func=self.cfg_func, device=d))

    @torch.no_grad()
    def segment_batch(self, imgs_raw, mesh=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """imgs_raw: [B,S,S,3] RGB 0..255, uint8 or float, numpy or a
        tensor (or placed on ``mesh``) -> (morph, func) labels, each
        [B,S,S] int32 on the device (the first shard's, with a mesh).
        Nothing of the ADP step reduces over the batch, so with a mesh
        every shard runs the whole step on its images, whichever program
        the reference would run."""
        with span('wsss.hsn.segment_batch'):
            if mesh is not None:
                (imgs,), b0 = shard_batch(mesh, imgs_raw)
                return map_shards(
                    mesh, lambda d, x: self._on(d).segment_batch(x), imgs,
                    b0=b0)
            with span('wsss.io.to_device'):
                imgs = torch.as_tensor(imgs_raw).to(self.device,
                                                    torch.float32)
            cs_m, cs_f = self.probs(imgs)
            q_m = mean_field(cs_m, imgs, self.cfg_morph)
            q_f = mean_field(cs_f, imgs, self.cfg_func)
            return (torch.argmax(q_m, dim=-1).to(torch.int32),
                    torch.argmax(q_f, dim=-1).to(torch.int32))
