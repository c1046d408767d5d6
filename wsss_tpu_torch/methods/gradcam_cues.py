"""Grad-CAM weak-cue generation of the port, the reference's 02_cues stage
(counterpart of ``wsss_tpu/methods/gradcam_cues.py``).

A batch's whole body — normalize, classifier forward, CAM einsum, the
41x41 seed resize, thresholding and overlap resolution — runs on the
handles' device; only the sparse pickle packing runs on the host.

Flavors:
  * VOC2012 — fg + bg networks, bg cues from the bg net's lowest decile
    (02_cues/demo.py:134-214, utilities.py:183-234).
  * DeepGlobe — fg only, no background channel (utilities.py:236-278).
  * ADP — one 31/51-way network split into morph + func seed sets with
    synthesized Background / Other channels (02_cues/demo.py:224-321,
    adp_cues.py:244-339).

Handles build their classifier at ``models.backbones.infer_dtype()``:
float32 unless WSSS_TPU_BF16_INFER asks for bfloat16.  ``run(mesh=)``
cuts each batch over the mesh's 'data' axis (``parallel.mesh``), one
replica of the handles per distinct device.  VOC / DeepGlobe's cue
threshold takes a per-class max over the whole batch, so their shards'
seed CAMs are gathered onto the first shard's device before the cues are
made, as the reference's GSPMD program reduces over the global batch: the
cues equal the unsharded run's.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from wsss_tpu_torch.data import registry
from wsss_tpu_torch.io import artifacts
from wsss_tpu_torch.io.flax_bridge import load_flax_variables
from wsss_tpu_torch.models.backbones import (build_classifier, infer_dtype,
                                             init_random)
from wsss_tpu_torch.ops import cues as cue_ops
from wsss_tpu_torch.ops import gradcam as gc_ops
from wsss_tpu_torch.ops.filters import resize_bilinear
from wsss_tpu_torch.parallel.mesh import map_shards, mesh_batches, on_device
from wsss_tpu_torch.utils.device import resolve_device

SEED_SIZE = 41  # 02_cues/demo.py:65


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
    own head: mean for VGG16, max for M7), in the model's compute
    dtype."""

    def __init__(self, model: torch.nn.Module, thresholds, input_size: int,
                 device='cuda'):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.thresholds = torch.as_tensor(
            np.array(thresholds, np.float32).reshape(-1),
            device=self.device)
        self.input_size = input_size
        self.weights = gc_ops.gradcam_weights(
            model.features, model.head_logits, (input_size, input_size),
            self.device)

    def to(self, device) -> '_ClassifierHandle':
        """This handle on ``device``: itself where it lives there, else a
        copy of its model, thresholds and Grad-CAM weights."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        h = copy.copy(self)
        h.device = dev
        h.model = copy.deepcopy(self.model).to(dev)
        h.thresholds = self.thresholds.to(dev)
        h.weights = self.weights.to(dev)
        return h

    @classmethod
    def random(cls, model_type: str, num_classes: int, input_size: int,
               seed: int = 0, thresholds=0.5, device='cuda'):
        """Untrained handle: flax-style random init drawn from a seeded
        torch.Generator, thresholds flat 0.5 by default (the reference's
        missing-.mat fallback, adp_cues.py:118-120) or given per class."""
        model = build_classifier(model_type, num_classes,
                                 dtype=infer_dtype())
        init_random(model, torch.Generator().manual_seed(seed))
        th = np.broadcast_to(np.asarray(thresholds, np.float32),
                             (num_classes,))
        return cls(model, th, input_size, device=device)

    @classmethod
    def from_flax(cls, model_type: str, numpy_variables: Mapping,
                  thresholds, input_size: int, device='cuda'):
        """Handle carrying the JAX package's flax variables (numpy leaves)
        across through ``io.flax_bridge``."""
        num_classes = np.shape(numpy_variables['params']['head']['bias'])[0]
        model = load_flax_variables(
            build_classifier(model_type, num_classes, dtype=infer_dtype()),
            numpy_variables)
        return cls(model, thresholds, input_size, device=device)


def _to(x, device) -> torch.Tensor:
    """A host batch (numpy or tensor) as float32 on ``device``."""
    return torch.as_tensor(x).to(device, torch.float32, non_blocking=True)


class VOCDeepGlobeCueGenerator:
    """Cue generation for VOC2012 (fg+bg nets) and DeepGlobe (fg only) on
    one device; the handles must live on that device."""

    def __init__(self, spec: registry.DatasetSpec, fg: _ClassifierHandle,
                 bg: Optional[_ClassifierHandle] = None,
                 thresh: float = 0.2, seed_size: int = SEED_SIZE,
                 device='cuda'):
        self.device = resolve_device(device)
        for h in (fg, bg):
            if h is not None and h.device != self.device:
                raise ValueError(f'handle on {h.device}, generator on '
                                 f'{self.device}')
        if spec.uses_bg_net and bg is None:
            raise ValueError(f'{spec.name} needs a background network '
                             '(02_cues/demo.py:136-148)')
        self.spec = spec
        self.fg, self.bg = fg, bg
        self.thresh = thresh
        self.seed_size = seed_size
        self._norm = _normalizer(spec.norm_cues, self.device)

    def _run_net(self, handle, x, gt_tags):
        scores, feats = handle.model(x)
        is_pass = (scores >= handle.thresholds[None]) & (gt_tags > 0.5)
        cams = gc_ops.grad_cam(feats, handle.weights, is_pass)
        return resize_bilinear(cams, (self.seed_size,) * 2), is_pass

    def _cams(self, imgs_raw, gt_tags):
        """(fg seed CAMs, bg seed CAMs or None, is_pass) of a batch."""
        x = self._norm(_to(imgs_raw, self.device))
        tags = _to(gt_tags, self.device)
        h_fg, is_pass = self._run_net(self.fg, x, tags)
        h_bg = (self._run_net(self.bg, x, tags)[0] if self.bg is not None
                else None)
        return h_fg, h_bg, is_pass

    def _cues(self, h_fg, h_bg) -> torch.Tensor:
        if h_bg is not None:
            return cue_ops.fgbg_cues(h_fg, h_bg, self.thresh)
        return cue_ops.fg_cues(h_fg, self.thresh)

    @torch.no_grad()
    def generate_batch(self, imgs_raw, gt_tags
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """imgs_raw: [B,S,S,3] 0..255 RGB; gt_tags: [B,C_fg] (numpy or
        tensors).  Returns (one-hot cues bool [B,41,41,C_seg], is_pass
        bool [B,C_fg]) on the device."""
        h_fg, h_bg, is_pass = self._cams(imgs_raw, gt_tags)
        return self._cues(h_fg, h_bg), is_pass

    @torch.no_grad()
    def _generate_sharded(self, mesh, imgs, tags, b0):
        """generate_batch over a batch cut on ``mesh``: each shard's seed
        CAMs on its device, gathered onto the first shard's (B x 41 x 41
        x C), where the cues take their threshold's max over the whole
        batch, as the reference's GSPMD program does."""
        def cams(d, x, t):
            h_fg, h_bg, is_pass = self._on(d)._cams(x, t)
            return (h_fg, is_pass) if h_bg is None else (h_fg, is_pass, h_bg)
        h_fg, is_pass, *h_bg = map_shards(mesh, cams, imgs, tags, b0=b0)
        return self._cues(h_fg, h_bg[0] if h_bg else None), is_pass

    def class_inds(self, is_pass: np.ndarray) -> List[np.ndarray]:
        """'{i}_labels' values (02_cues/demo.py:205-208): VOC offsets fg
        indices by +1 for the bg channel; DeepGlobe stores raw indices."""
        off = 1 if self.spec.uses_bg_net else 0
        return [np.where(np.asarray(p))[0] + off for p in is_pass]

    def _on(self, device) -> 'VOCDeepGlobeCueGenerator':
        return on_device(self, device, lambda d: VOCDeepGlobeCueGenerator(
            self.spec, self.fg.to(d), None if self.bg is None
            else self.bg.to(d), self.thresh, self.seed_size, device=d))

    def run(self, batches, verbose: bool = False,
            mesh=None) -> Dict[str, np.ndarray]:
        """Full-split cue generation -> pickle-format dict.  mesh: each
        batch is cut over its 'data' axis, placed ahead by the prefetch
        thread of ``mesh_batches``."""
        out: Dict[str, np.ndarray] = {}
        for b, (imgs, tags), b0 in mesh_batches(
                mesh, batches, lambda b: (b.images, b.tags)):
            if mesh is not None:
                onehot, is_pass = self._generate_sharded(mesh, imgs, tags,
                                                         b0)
            else:
                onehot, is_pass = self.generate_batch(imgs, tags)
            artifacts.pack_cues(onehot.cpu().numpy(),
                                self.class_inds(is_pass.cpu().numpy()),
                                list(b.indices), out)
            if verbose:
                print(f'  cues for images {b.indices[0]}..{b.indices[-1]}')
        return out


class ADPCueGenerator:
    """ADP morph+func cue generation from one 31/51-way HistoNet
    (02_cues/demo.py:224-321) on one device."""

    def __init__(self, handle: _ClassifierHandle, model_family: str,
                 thresh: float = 0.2, seed_size: int = SEED_SIZE,
                 device='cuda'):
        self.device = resolve_device(device)
        if handle.device != self.device:
            raise ValueError(f'handle on {handle.device}, generator on '
                             f'{self.device}')
        self.handle = handle
        self.thresh = thresh
        self.seed_size = seed_size
        self.model_family = model_family
        self.maps = registry.adp_index_maps(model_family)
        self.morph_spec = registry.get('ADP-morph')
        self.func_spec = registry.get('ADP-func')
        self.is_x17 = model_family.upper().startswith('X1')
        self._norm = _normalizer(self.morph_spec.norm_cues, self.device)
        base = registry.ADP_CLASSES_VGG16

        def among(names):
            return np.array([i for i, c in enumerate(base) if c in names])

        def index(a):
            return torch.as_tensor(a, dtype=torch.long, device=self.device)

        # positions of morph/func/adipose classes within the 31-class set
        self._morph31 = among(registry.ADP_MORPH_CLASSES)
        self._func31 = among(registry.ADP_FUNC_CLASSES)
        adipose31 = among(registry.ADP_ADIPOSE_CLASSES)
        self._all31_t = index(self._all31())
        self._morph31_t = index(self._morph31)
        self._func31_t = index(self._func31)
        self._adipose_in_morph = [
            int(i) for i in 1 + np.searchsorted(self._morph31, adipose31)]
        self._func_exc = [self.func_spec.seg_class_names.index(c)
                          for c in registry.ADP_BG_EXCEPTION['func']]

    def _all31(self) -> np.ndarray:
        return self.maps['x17_to_31'] if self.is_x17 else self.maps['all']

    @torch.no_grad()
    def generate_batch(self, imgs_raw
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """imgs_raw: [B,S,S,3] 0..255 RGB.  Returns (morph one-hot
        [B,41,41,29], func one-hot [B,41,41,5], is_pass [B,C_out]) on the
        device."""
        h = self.handle
        imgs = _to(imgs_raw, self.device)
        scores, feats = h.model(self._norm(imgs))
        is_pass = scores >= h.thresholds[None]
        cams = gc_ops.grad_cam(feats, h.weights, torch.ones_like(is_pass))
        cams = resize_bilinear(cams, (self.seed_size,) * 2)  # [B,41,41,C]
        cams31 = cams[..., self._all31_t]
        pass31 = is_pass[:, self._all31_t].to(cams.dtype)
        # morph seeds: [bg] + 28 classes
        morph = cams31.new_zeros(cams31.shape[:3]
                                 + (self.morph_spec.n_seg_classes,))
        morph[..., 1:] = (cams31[..., self._morph31_t]
                          * pass31[:, None, None, self._morph31_t])
        morph = cue_ops.modify_by_htt(
            morph, imgs, exception_inds=self._adipose_in_morph, bg_ind=0)
        # func seeds: [bg, other] + 3 classes
        func = cams31.new_zeros(cams31.shape[:3]
                                + (self.func_spec.n_seg_classes,))
        func[..., 2:] = (cams31[..., self._func31_t]
                         * pass31[:, None, None, self._func31_t])
        adipose_cam = torch.amax(morph[..., self._adipose_in_morph], dim=-1)
        func = cue_ops.modify_by_htt(
            func, imgs, exception_inds=self._func_exc, bg_ind=0,
            other_ind=1, adipose_cam=adipose_cam)
        # per-image-max thresholds + overlap (adp_cues.py:304-339)
        onehot_m = cue_ops.fg_cues(morph, self.thresh, per_image_max=True)
        onehot_f = cue_ops.fg_cues(func, self.thresh, per_image_max=True)
        return onehot_m, onehot_f, is_pass

    def class_inds(self, is_pass: np.ndarray
                   ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """valid-set indices of passing classes; func prepends 'Other'=1
        (02_cues/demo.py:300-309)."""
        p31 = is_pass[:, self._all31()]
        base = registry.ADP_CLASSES_VGG16
        morph2valid = np.array(
            [self.morph_spec.seg_class_names.index(c) for c in base
             if c in registry.ADP_MORPH_CLASSES])
        func2valid = np.array(
            [self.func_spec.seg_class_names.index(c) for c in base
             if c in registry.ADP_FUNC_CLASSES])
        m_inds = [morph2valid[p31[i, self._morph31] > 0.5]
                  for i in range(p31.shape[0])]
        f_inds = [np.append(1, func2valid[p31[i, self._func31] > 0.5])
                  for i in range(p31.shape[0])]
        return m_inds, f_inds

    def _on(self, device) -> 'ADPCueGenerator':
        return on_device(self, device, lambda d: ADPCueGenerator(
            self.handle.to(d), self.model_family, self.thresh,
            self.seed_size, device=d))

    def run(self, batches, verbose: bool = False, mesh=None
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Full-split cue generation -> (morph, func) pickle dicts; mesh as
        in ``VOCDeepGlobeCueGenerator.run``."""
        out_m: Dict[str, np.ndarray] = {}
        out_f: Dict[str, np.ndarray] = {}
        for b, (imgs,), b0 in mesh_batches(mesh, batches,
                                           lambda b: (b.images,)):
            if mesh is not None:
                oh_m, oh_f, is_pass = map_shards(
                    mesh, lambda d, x: self._on(d).generate_batch(x), imgs,
                    b0=b0)
            else:
                oh_m, oh_f, is_pass = self.generate_batch(imgs)
            m_inds, f_inds = self.class_inds(is_pass.cpu().numpy())
            artifacts.pack_cues(oh_m.cpu().numpy(), m_inds,
                                list(b.indices), out_m)
            artifacts.pack_cues(oh_f.cpu().numpy(), f_inds,
                                list(b.indices), out_f)
            if verbose:
                print(f'  ADP cues for images '
                      f'{b.indices[0]}..{b.indices[-1]}')
        return out_m, out_f


def _nearest_resize(arr: np.ndarray, hw) -> np.ndarray:
    """Nearest resize of a [H,W] map (cv2.INTER_NEAREST stand-in), the
    reference's ``jax.image.resize(..., 'nearest')`` on the host: source
    index floor((i + 0.5) * in / out) in float32.  Returns float32."""
    out = np.asarray(arr, np.float32)
    for axis, n in enumerate(hw):
        m = out.shape[axis]
        if m == n:
            continue
        src = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                       * np.float32(m) / np.float32(n)).astype(np.int32)
        out = np.take(out, src, axis=axis)
    return out


def save_cue_images(cue_dict: Dict[str, np.ndarray], gt_batches,
                    palette: np.ndarray, out_dir: str,
                    n_seg_classes: int, seed_size: int = SEED_SIZE,
                    dataset: str = 'VOC2012',
                    overlay_r: float = 0.75) -> int:
    """Debug PNGs for evaluated cues (02_cues/demo.py:466-477): the
    colorized cue prediction + an overlay on the original image (the
    reference downsamples DeepGlobe /4 there to save space; full size
    here, the overlay content is identical)."""
    from wsss_tpu_torch.eval import reports
    is_adp = dataset.startswith('ADP')
    n = 0
    for b in gt_batches:
        for j, name in enumerate(b.names):
            dense = artifacts.unpack_cues(
                cue_dict, int(b.indices[j]),
                (seed_size, seed_size, n_seg_classes))
            img = b.images[j]
            hw = img.shape[:2]
            if is_adp:
                # per-class accumulated color mask (demo.py:592-598 —
                # overlapping ADP cues sum their class colors)
                mask = np.zeros(hw + (3,), np.float32)
                for k in range(n_seg_classes):
                    up = _nearest_resize(dense[:, :, k], hw) == 1.0
                    mask += up[..., None] * palette[k][None, None]
                color = np.clip(mask, 0, 255).astype(np.uint8)
            else:
                lab = np.argmax(dense, -1)
                if dataset.startswith('DeepGlobe'):
                    lab[dense.sum(-1) == 0] = n_seg_classes - 1
                up = _nearest_resize(lab, hw).astype(np.int32)
                color = reports.colorize(up, palette)
            reports.save_png(os.path.join(out_dir, name + '.png'), color)
            reports.save_png(
                os.path.join(out_dir, name + '_overlay.png'),
                reports.overlay(np.asarray(img, np.float32), color,
                                overlay_r))
            n += 1
    return n


def eval_cues_miou(cue_dict: Dict[str, np.ndarray], gt_batches,
                   n_seg_classes: int, seed_size: int = SEED_SIZE,
                   dataset: str = 'VOC2012',
                   size: Optional[int] = None
                   ) -> Tuple[np.ndarray, float]:
    """Cue-quality mIoU vs GT, the reference's per-dataset accumulation
    (02_cues/demo.py:323-485, :583-625), on the host:

      * VOC2012 (demo.py:424-441): cue argmax at the 41x41 seed grid —
        un-cued pixels fall to argmax(zeros)=0, i.e. BACKGROUND — nearest-
        resized to GT size; per-class intersect/union over all 21 classes
        against the raw GT indices (255 border pixels match no class but
        still count in the union when predicted); mIoU = mean(I/(U+1e-7)).
      * DeepGlobe (demo.py:442-463): un-cued pixels set to ignore_ind=6
        (the dropped 'unknown' class), I/U accumulated over the first 6
        classes only.
      * ADP morph/func (demo.py:583-625): each class channel is an
        INDEPENDENT binary mask (cues may overlap across classes — no
        argmax), nearest-resized to the network input `size`; GT is also
        evaluated at `size`; IoU = I/U with NO epsilon, mIoU = plain mean.

    Returns (per-class IoU over the evaluated classes, mIoU)."""
    is_adp = dataset.startswith('ADP')
    is_dg = dataset.startswith('DeepGlobe')
    n_eval = n_seg_classes - 1 if is_dg else n_seg_classes
    intersects = np.zeros(n_eval, np.int64)
    unions = np.zeros(n_eval, np.int64)
    for b in gt_batches:
        if b.gt is None:
            continue
        dense = np.stack([
            artifacts.unpack_cues(cue_dict, int(i),
                                  (seed_size, seed_size, n_seg_classes))
            for i in b.indices])
        for j in range(dense.shape[0]):
            gt = b.gt[j]
            if is_adp:
                hw = (size, size) if size else gt.shape
                if gt.shape != hw:   # the reference evals ADP at net size
                    gt = _nearest_resize(gt, hw).astype(np.int32)
                # per-class binary channels, no argmax (demo.py:594-600)
                for k in range(n_eval):
                    pred_mask = _nearest_resize(dense[j, :, :, k],
                                                hw) == 1.0
                    gt_mask = gt == k
                    intersects[k] += int(np.sum(gt_mask & pred_mask))
                    unions[k] += int(np.sum(gt_mask | pred_mask))
                continue
            cue_lab = np.argmax(dense[j], -1)
            if is_dg:
                # un-cued -> ignore_ind (demo.py:450-451)
                cue_lab[dense[j].sum(-1) == 0] = n_eval
            pred = _nearest_resize(cue_lab, gt.shape).astype(np.int32)
            for k in range(n_eval):
                gt_mask = gt == k
                pred_mask = pred == k
                intersects[k] += int(np.sum(gt_mask & pred_mask))
                unions[k] += int(np.sum(gt_mask | pred_mask))
    if is_adp:
        with np.errstate(divide='ignore', invalid='ignore'):
            iou = intersects / unions            # demo.py:620 — no eps
    else:
        iou = intersects / (unions + 1e-7)       # demo.py:481
    return np.asarray(iou), float(np.mean(iou))
