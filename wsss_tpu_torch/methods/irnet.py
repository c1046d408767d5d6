"""IRNet of the port, the reference's 03b (counterpart of
``wsss_tpu/methods/irnet.py``).

Pipeline (03b_irn/func_sample.py:232-274):
  1. make_cam        — multi-scale + flip CAM inference (step/make_cam.py)
  2. eval_cam        — CAM mIoU (step/eval_cam.py; ``eval_cam_pred``)
  3. cam_to_ir_label — confident fg/bg + CRF label refinement
                       (step/cam_to_ir_label.py)
  4. train_irn       — affinity / displacement training of the heads
                       (step/train_irn.py; ``affinity_labels``,
                       ``IRNTrainer``)
  5. make_sem_seg    — random-walk propagation
                       (step/make_sem_seg_labels.py)

Every stage runs on one device (``device='cuda'`` by default, raising
without a card; ``'cpu'`` on request); the per-image dicts and label maps
that cross between stages are host numpy, the reference's on-disk
contract.  ``mesh=`` (``parallel.mesh``) cuts make_cam's batch over the
mesh's 'data' axis and make_sem_seg's transition matrix over its first
two axes; cam_to_ir_label takes no mesh, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods.gradcam_cues import (_ClassifierHandle,
                                                 _normalizer, _to)
from wsss_tpu_torch.ops import cues as cue_ops
from wsss_tpu_torch.ops.crf import config as crf_config
from wsss_tpu_torch.ops.crf.meanfield import crf_label_refine
from wsss_tpu_torch.ops.filters import resize_bilinear
from wsss_tpu_torch.models.backbones import init_random
from wsss_tpu_torch.models.irn import IRNet
from wsss_tpu_torch.ops.random_walk import (PathIndex, propagate_to_edge,
                                            propagate_to_edge_sharded,
                                            to_affinity_sliced)
from wsss_tpu_torch.parallel.mesh import map_shards, on_device, shard_batch
from wsss_tpu_torch.train.schedules import ScheduledSGD, poly_decay
from wsss_tpu_torch.utils.device import resolve_device

# optax.add_decayed_weights of the reference's chain (irnet.py:383)
WEIGHT_DECAY = 1e-4

def get_strided_size(hw, stride):
    """misc.imutils.get_strided_size (make_cam.py:41)."""
    return ((hw[0] - 1) // stride + 1, (hw[1] - 1) // stride + 1)


def get_strided_up_size(hw, stride):
    """misc.imutils.get_strided_up_size (make_cam.py:42)."""
    st = get_strided_size(hw, stride)
    return st[0] * stride, st[1] * stride


def _among(names) -> np.ndarray:
    """Positions of ``names`` among the 31 ADP classes."""
    return np.array([i for i, c in enumerate(registry.ADP_CLASSES_VGG16)
                     if c in names])


# ---------------------------------------------------------------------------
# Step 1: make_cam — multi-scale+flip CAM inference
# ---------------------------------------------------------------------------

class CAMInference:
    """MSF CAM (step/make_cam.py:25-93 + net/{vgg16,m7}_cam.py).

    The CAM convolves the final conv features with the classifier's
    weight matrix (VGG16, vgg16_cam.py:48) or the stored Grad-CAM weights
    (M7 / X1.7, m7_cam.py:45-48); image + horizontal flip are summed.
    Each scale's forward runs once for a batch of same-shape images with
    image and flip in the batch axis, and the strided and high-res
    targets are two resizes of the same CAM (the reference dispatches per
    image, scale and target, make_cam.py:56-69).  The handle must live on
    ``device``."""

    def __init__(self, handle: _ClassifierHandle, spec: registry.DatasetSpec,
                 model_type: str = 'VGG16',
                 scales: Sequence[float] = (1.0, 0.5, 1.5, 2.0),
                 adp_htt: Optional[str] = None, device='cuda'):
        self.device = resolve_device(device)
        if handle.device != self.device:
            raise ValueError(f'handle on {handle.device}, CAMInference on '
                             f'{self.device}')
        self.handle = handle
        self.spec = spec
        self.scales = tuple(scales)
        self.adp_htt = adp_htt
        self.model_type = model_type
        self._norm = _normalizer(spec.norm_irn, self.device)
        self._is_x17 = model_type.upper().startswith('X1')
        self._maps = registry.adp_index_maps(model_type) if adp_htt else None
        if model_type.upper().startswith('VGG'):
            # pure CAM: the classifier's Dense kernel [F, C]
            self._cam_w = handle.model.head.weight.detach().t()
        else:
            self._cam_w = handle.weights   # M7/X1.7: Grad-CAM weights [F, C]
        self._cam_w = self._cam_w.to(torch.float32)

    @torch.no_grad()
    def _msf_batch(self, imgs: torch.Tensor):
        """imgs: [B,H,W,3] raw RGB on the device.  Returns (cam [B,C,sh,sw],
        high_res [B,C,uh,uw] cropped to [H, W], scores [B,C_out]): the
        multi-scale sums, flip-merged."""
        b, h, w = imgs.shape[:3]
        strided = get_strided_size((h, w), 4)
        up = get_strided_up_size((h, w), 16)
        cam_sum = hi_sum = scores0 = None
        for s in self.scales:
            img_s = resize_bilinear(imgs, (int(round(h * s)),
                                           int(round(w * s))))
            both = torch.cat([img_s, img_s.flip(2)])
            scores, feats = self.handle.model(self._norm(both))
            cam = torch.relu(torch.einsum('bhwf,fc->bhwc',
                                          feats.to(torch.float32),
                                          self._cam_w))
            cam = cam[:b] + cam[b:].flip(2)              # merge the flip
            cs, cu = resize_bilinear(cam, strided), resize_bilinear(cam, up)
            cam_sum = cs if cam_sum is None else cam_sum + cs
            hi_sum = cu if hi_sum is None else hi_sum + cu
            if s == 1.0:
                scores0 = scores[:b]
        if scores0 is None:
            scores0 = torch.zeros((b, self._cam_w.shape[1]),
                                  device=self.device)
        return (cam_sum.permute(0, 3, 1, 2),
                hi_sum[:, :h, :w].permute(0, 3, 1, 2), scores0)

    def _modify_adp(self, cam31: torch.Tensor, img_raw: torch.Tensor
                    ) -> torch.Tensor:
        """ADP bg/other synthesis (net/common_cam.py:31-92) on [C,h,w]:
        morph clamps bg at 0 (relu), func does not."""
        morph31 = _among(registry.ADP_MORPH_CLASSES)
        func31 = _among(registry.ADP_FUNC_CLASSES)
        adipose31 = _among(registry.ADP_ADIPOSE_CLASSES)
        cam_hwc = cam31.permute(1, 2, 0)[None]
        if self.adp_htt == 'morph':
            vol = torch.zeros(cam_hwc.shape[:3] + (1 + len(morph31),),
                              device=cam31.device)
            vol[..., 1:] = cam_hwc[..., morph31]
            vol = cue_ops.modify_by_htt(
                vol, img_raw, exception_inds=[
                    int(i) for i in 1 + np.searchsorted(morph31, adipose31)],
                bg_ind=0, relu_bg=True)
        else:
            vol = torch.zeros(cam_hwc.shape[:3] + (2 + len(func31),),
                              device=cam31.device)
            vol[..., 2:] = cam_hwc[..., func31]
            adipose_cam = torch.amax(cam_hwc[..., adipose31], dim=-1)
            vol = cue_ops.modify_by_htt(
                vol, img_raw, exception_inds=list(range(2, 2 + len(func31))),
                bg_ind=0, other_ind=1, adipose_cam=adipose_cam)
        return vol[0].permute(2, 0, 1)

    def _on(self, device) -> 'CAMInference':
        return on_device(self, device, lambda d: CAMInference(
            self.handle.to(d), self.spec, self.model_type, self.scales,
            self.adp_htt, device=d))

    def make_cam_batch(self, imgs_raw, tags: Optional[np.ndarray],
                       mesh=None) -> list:
        """Batch of same-shape images -> list of {'keys','cam','high_res'}
        dicts of host numpy (make_cam.py:78-88 per image).

        imgs_raw: [B,H,W,3] RGB 0..255 (numpy or a tensor).  tags:
        [B,C_fg] or None.  mesh: the MSF forwards run on the batch's
        shards over the mesh's 'data' axis; the per-image finish on this
        device."""
        imgs = _to(imgs_raw, self.device)
        if mesh is not None:
            (sh,), b0 = shard_batch(mesh, imgs_raw)
            cam, hi, scores = map_shards(
                mesh, lambda d, x: self._on(d)._msf_batch(_to(x, d)), sh,
                b0=b0, device=self.device)
        else:
            cam, hi, scores = self._msf_batch(imgs)
        return [self._finalize(imgs[i], cam[i], hi[i], scores[i],
                               None if tags is None else np.asarray(tags[i]))
                for i in range(imgs.shape[0])]

    def make_cam(self, img_raw, tags: Optional[np.ndarray]
                 ) -> Dict[str, np.ndarray]:
        """One image -> {'keys','cam','high_res'} (make_cam.py:78-88).

        img_raw: [H,W,3] RGB 0..255.  tags: [C_fg] image labels (train
        split) or None (thresholded predictions, make_cam.py:49-52)."""
        return self.make_cam_batch(
            img_raw[None], None if tags is None else tags[None])[0]

    @torch.no_grad()
    def _finalize(self, img, cam31, hi31, scores0, tags
                  ) -> Dict[str, np.ndarray]:
        """Per-image key selection / ADP synthesis / normalization."""
        th = self.handle.thresholds.cpu().numpy()
        if self._is_x17:
            keep = self._maps['x17_to_31']
            keep_t = torch.as_tensor(keep, device=cam31.device)
            cam31, hi31 = cam31[keep_t], hi31[keep_t]
            scores0, th = scores0[keep_t], th[keep]
        sc = scores0.cpu().numpy()
        if self.adp_htt:
            img_raw = img[None]
            cam31 = self._modify_adp(cam31, img_raw)
            hi31 = self._modify_adp(hi31, img_raw)
            nbg = 1 if self.adp_htt == 'morph' else 2
            fg31 = _among(registry.ADP_MORPH_CLASSES if self.adp_htt == 'morph'
                          else registry.ADP_FUNC_CLASSES)
            valid_fg = (np.where(tags > 0.5)[0] if tags is not None else
                        np.where(sc[fg31] >= th[fg31])[0])
            keys = np.concatenate([np.arange(nbg), valid_fg + nbg])
        else:
            if tags is not None:
                keys = np.where(tags > 0.5)[0]
            else:
                passed = sc >= th
                if not passed.any():
                    passed[sc.argmax()] = True  # vgg16_cam.py:41-42
                keys = np.where(passed)[0]
        if len(keys) == 0:
            return {'keys': np.empty(0, np.int64),
                    'cam': np.empty(0), 'high_res': np.empty(0)}
        sel = torch.as_tensor(keys, device=cam31.device)
        cam31, hi31 = cam31[sel], hi31[sel]
        cam31 = cam31 / (torch.amax(cam31, dim=(1, 2), keepdim=True) + 1e-5)
        hi31 = hi31 / (torch.amax(hi31, dim=(1, 2), keepdim=True) + 1e-5)
        return {'keys': np.asarray(keys),
                'cam': cam31.cpu().numpy(),
                'high_res': hi31.cpu().numpy()}


# ---------------------------------------------------------------------------
# Step 2: eval_cam label assembly
# ---------------------------------------------------------------------------

def eval_cam_pred(cam_dict: Dict[str, np.ndarray], dataset: str,
                  cam_eval_thres: float) -> Optional[np.ndarray]:
    """Per-dataset CAM -> label-map assembly, exactly eval_cam.py:48-62:

      * VOC2012: pad a constant `cam_eval_thres` channel in front of
        high_res and shift keys by the background class (:49-52).
      * ADP: argmax the raw high_res channels — keys already include the
        background classes (make_cam.py:54-61), no padding (:53-55).
      * DeepGlobe: argmax the raw STRIDED 'cam' array with raw keys
        (:56-58) — NOT high_res.

    Returns the label map at the cams' resolution, or None when the cam
    dict is empty for a non-VOC dataset (the reference would crash on
    argmax of an empty array; such images are skipped).  Host numpy."""
    if dataset == 'VOC2012':
        cams = np.pad(cam_dict.get('high_res', cam_dict['cam']),
                      ((1, 0), (0, 0), (0, 0)),
                      constant_values=cam_eval_thres)
        keys = np.pad(cam_dict['keys'] + 1, (1, 0), mode='constant')
    elif dataset.startswith('ADP'):
        if cam_dict['keys'].size == 0:
            return None
        keys = cam_dict['keys']
        cams = cam_dict.get('high_res', cam_dict['cam'])
    else:                              # DeepGlobe / DeepGlobe_balanced
        if cam_dict['keys'].size == 0:
            return None
        keys = cam_dict['keys']
        cams = cam_dict['cam']
    return np.asarray(keys)[np.argmax(cams, axis=0)]


# ---------------------------------------------------------------------------
# Step 3: cam_to_ir_label
# ---------------------------------------------------------------------------

def _refine(img: torch.Tensor, lab: np.ndarray, n: int, cfg) -> np.ndarray:
    return crf_label_refine(img, torch.as_tensor(lab, device=img.device), n,
                            cfg).cpu().numpy()


def cam_to_ir_label(img_raw, cam_dict: Dict[str, np.ndarray], dataset: str,
                    conf_fg_thres: float, conf_bg_thres: float = 0.05,
                    cfg: crf_config.CRFConfig = crf_config.IRN_LABEL,
                    device='cuda') -> np.ndarray:
    """step/cam_to_ir_label.py:18-77 — confident-region pseudo labels with
    CRF refinement; 255 = ignore.  The CRF runs on ``device``: two calls
    an image on VOC (fg and bg thresholds), one on ADP and DeepGlobe.
    Returns uint8 host labels."""
    keys = cam_dict['keys']
    if keys.size == 0:
        return np.full(np.shape(img_raw)[:2], 255, np.uint8)
    img = torch.as_tensor(img_raw).to(resolve_device(device), torch.float32)
    if dataset == 'VOC2012':
        keys_pad = np.pad(keys + 1, (1, 0), mode='constant')
        hr = np.pad(cam_dict['high_res'], ((1, 0), (0, 0), (0, 0)),
                    constant_values=conf_fg_thres)
        fg_conf = keys_pad[_refine(img, np.argmax(hr, 0), len(keys_pad),
                                   cfg)]
        hr_bg = np.pad(cam_dict['high_res'], ((1, 0), (0, 0), (0, 0)),
                       constant_values=conf_bg_thres)
        bg_conf = keys_pad[_refine(img, np.argmax(hr_bg, 0), len(keys_pad),
                                   cfg)]
        conf = fg_conf.copy()
        conf[fg_conf == 0] = 255
        conf[(bg_conf + fg_conf) == 0] = 0
    else:
        # ADP / DeepGlobe (cam_to_ir_label.py:29-41,59-74); DeepGlobe
        # downsamples the image x4 (to a square, as the reference does)
        # and uses the strided cam
        keys_pad = np.concatenate([[-1], keys])
        src = 'cam' if dataset.startswith('DeepGlobe') else 'high_res'
        cam = cam_dict[src]
        if dataset.startswith('DeepGlobe'):
            h4 = img.shape[0] // 4
            img = resize_bilinear(img[None], (h4, h4))[0]
            cam_t = torch.as_tensor(cam, dtype=torch.float32,
                                    device=img.device).permute(1, 2, 0)
            cam = resize_bilinear(cam_t[None], (h4, h4))[0].permute(
                2, 0, 1).cpu().numpy()
        hr = np.pad(cam, ((1, 0), (0, 0), (0, 0)),
                    constant_values=conf_fg_thres)
        conf = keys_pad[_refine(img, np.argmax(hr, 0), len(keys_pad),
                                cfg)].astype(np.int64)
        conf[conf == -1] = 255
    return conf.astype(np.uint8)


# ---------------------------------------------------------------------------
# Step 4: train_irn
# ---------------------------------------------------------------------------

def affinity_labels(ir_label_reduced: np.ndarray, path_index: PathIndex,
                    n_valid_classes: int):
    """GetAffinityLabelFromIndices (voc12/dataloader.py:108-134).

    ir_label_reduced: [h,w] int (255 = ignore) at the /4 grid.
    Returns (bg_pos, fg_pos, neg) float32 [P, M], host numpy."""
    src, dst = path_index.pair_indices(ir_label_reduced.shape)
    flat = ir_label_reduced.reshape(-1)
    lab_from = flat[src][None]          # [1,M]
    lab_to = flat[dst]                  # [P,M]
    valid = (lab_from < n_valid_classes) & (lab_to < n_valid_classes)
    equal = lab_from == lab_to
    pos = equal & valid
    bg_pos = (pos & (lab_from == 0)).astype(np.float32)
    fg_pos = (pos & (lab_from > 0)).astype(np.float32)
    neg = (~equal & valid).astype(np.float32)
    return bg_pos, fg_pos, neg


class IRNTrainer:
    """train_irn step (train_irn.py:14-168): affinity + displacement
    losses, PolyOptimizer with dp-head lr x10, post-training displacement
    mean calibration.  The IRNet lives on ``device``; only its heads
    train (the trunk runs under ``no_grad`` in eval mode and is in no
    optimizer group: the reference's ``set_to_zero`` gives it the same
    zero update).  The affinity labels carry the classes."""

    def __init__(self, backbone: str, crop_size: int, radius: int = 10,
                 lr: float = 0.1, max_step: int = 1000, device='cuda'):
        self.device = resolve_device(device)
        self.net = IRNet(backbone).to(self.device)
        grid = (crop_size // 4, crop_size // 4)
        # reference geometry: radius 10 on a crop/4 grid (train_irn.py:16);
        # clamp for tiny debug grids where the crop margin would vanish
        radius = min(radius, max(2, min(grid) // 2))
        self.path_index = PathIndex(radius)
        self.grid = grid
        self.disp_target = torch.as_tensor(
            self.path_index.search_dst.T[None, :, :, None],
            dtype=torch.float32, device=self.device)    # [1,2,P,1]
        rf = self.path_index.radius_floor
        self.crop_hw = (grid[0] - rf, grid[1] - 2 * rf)
        self.lr, self.max_step = lr, max_step
        self.tx = self._optimizer()

    def _optimizer(self) -> ScheduledSGD:
        """optax's chain (irnet.py:371-390) as two SGD groups.  Its
        ``add_decayed_weights`` has no mask: every head parameter decays,
        GroupNorm scales and biases too.  The dp group's ``scale(10)``
        sits between the decay and the momentum trace; the trace is
        linear and starts at zero, so a x10 step size is the same update
        (train_irn.py:89)."""
        groups = {'edge': [], 'dp': []}
        for name, p in self.net.named_parameters():
            head = name.split('.')[0]
            if head.startswith('fc_dp'):
                groups['dp'].append(p)
            elif head.startswith('fc_edge'):
                groups['edge'].append(p)
        return ScheduledSGD(
            [{'params': groups['edge'], 'mult': 1.0,
              'weight_decay': WEIGHT_DECAY},
             {'params': groups['dp'], 'mult': 10.0,
              'weight_decay': WEIGHT_DECAY}],
            poly_decay(self.lr, self.max_step), momentum=0.9,
            nesterov=False)

    def init(self, generator: torch.Generator) -> None:
        """flax's default initialisation of the heads drawn from
        ``generator`` (a CPU generator), and a fresh optimizer state.  The
        trunk keeps what it holds: the CLI pours the classifier's trunk
        in (``models.transplant``)."""
        for name, mod in self.net.named_children():
            if name != 'trunk':
                init_random(mod, generator)
        self.tx = self._optimizer()

    def _pair_displacement(self, disp: torch.Tensor) -> torch.Tensor:
        """to_pair_displacement (vgg16_irn.py:264-283). disp: [B,h,w,2].
        Returns [B,2,P,M]."""
        rf = self.path_index.radius_floor
        ch, cw = self.crop_hw
        d = disp.permute(0, 3, 1, 2)                    # [B,2,h,w]
        b = d.shape[0]
        src = d[:, :, :ch, rf:rf + cw].reshape(b, 2, 1, -1)
        dst = torch.stack([d[:, :, dy:dy + ch, rf + dx:rf + dx + cw]
                           for dy, dx in self.path_index.search_dst],
                          dim=2).reshape(b, 2, len(self.path_index
                                                   .search_dst), -1)
        return src - dst

    def losses(self, imgs_norm: torch.Tensor, bg_pos: torch.Tensor,
               fg_pos: torch.Tensor, neg: torch.Tensor):
        """train_irn.py:112-125 on the device: (total, {pos_aff, neg_aff,
        dp_fg, dp_bg})."""
        edge, disp = self.net(imgs_norm)
        # irnet.py:422 as written: M7's /2-grid edge *logits* are resized
        # onto the crop/4 affinity grid (an antialiased 2x downsample)
        # before the sigmoid; VGG16 / ResNet50 emit /4 directly
        if tuple(edge.shape[1:3]) != self.grid:
            edge = resize_bilinear(edge, self.grid)
        aff = to_affinity_sliced(torch.sigmoid(edge[..., 0]),
                                 self.path_index)       # [B,P,M]
        pos_aff_loss = -torch.log(aff + 1e-5)
        neg_aff_loss = -torch.log(1.0 + 1e-5 - aff)
        pair_disp = self._pair_displacement(disp)       # [B,2,P,M]
        dp_fg_loss = torch.abs(pair_disp - self.disp_target)
        dp_bg_loss = torch.abs(pair_disp)

        bg_pos_l = torch.sum(bg_pos * pos_aff_loss) / (torch.sum(bg_pos)
                                                       + 1e-5)
        fg_pos_l = torch.sum(fg_pos * pos_aff_loss) / (torch.sum(fg_pos)
                                                       + 1e-5)
        pos_l = bg_pos_l / 2 + fg_pos_l / 2
        neg_l = torch.sum(neg * neg_aff_loss) / (torch.sum(neg) + 1e-5)
        dp_fg_l = torch.sum(dp_fg_loss * fg_pos[:, None]) / (
            2 * torch.sum(fg_pos) + 1e-5)
        dp_bg_l = torch.sum(dp_bg_loss * bg_pos[:, None]) / (
            2 * torch.sum(bg_pos) + 1e-5)
        total = (pos_l + neg_l) / 2 + (dp_fg_l + dp_bg_l) / 2
        return total, {'pos_aff': pos_l, 'neg_aff': neg_l,
                       'dp_fg': dp_fg_l, 'dp_bg': dp_bg_l}

    def train_step(self, imgs_norm, bg_pos, fg_pos, neg
                   ) -> Dict[str, torch.Tensor]:
        """One step on a normalized NHWC batch and its [B,P,M] affinity
        labels: forward, losses, backward into the heads, optimizer.
        Returns the detached loss parts and 'total' as device tensors (no
        host sync)."""
        to = lambda x: torch.as_tensor(x).to(self.device, torch.float32)
        self.net.train()
        loss, parts = self.losses(to(imgs_norm), to(bg_pos), to(fg_pos),
                                  to(neg))
        self.net.zero_grad()
        loss.backward()
        self.tx.step()
        parts = {k: v.detach() for k, v in parts.items()}
        parts['total'] = loss.detach()
        return parts

    @torch.no_grad()
    def calibrate_disp_mean(self, img_batches) -> np.ndarray:
        """Displacement mean over an inference set (train_irn.py:152-165):
        the mean over batches of each batch's channel mean, float32 [2]
        on the host."""
        self.net.eval()
        means = [self.net(torch.as_tensor(imgs).to(self.device,
                                                   torch.float32))[1]
                 .mean(dim=(0, 1, 2)) for imgs in img_batches]
        return torch.stack(means).mean(dim=0).cpu().numpy()


# ---------------------------------------------------------------------------
# Step 5: make_sem_seg
# ---------------------------------------------------------------------------

def make_sem_seg(edge: torch.Tensor, cam_dict: Dict[str, np.ndarray],
                 dataset: str, orig_hw: Tuple[int, int],
                 beta: float = 10.0, exp_times: int = 8,
                 sem_seg_bg_thres: float = 0.25,
                 walk_downsample: int = 6, mesh=None,
                 device='cuda') -> np.ndarray:
    """step/make_sem_seg_labels.py:40-140 — random-walk propagation on
    ``device``.

    edge: [h,w] sigmoid edge map (resized onto the CAM grid here when it
    is not on it).  Returns uint8 host labels at the dataset's output
    resolution.

    walk_downsample: the reference's extra DeepGlobe /6 before the walk
    (make_sem_seg_labels.py:101-104), there because one card cannot hold
    the [N,N] transition matrix at full resolution; pass ``mesh`` to cut
    the matrix 2-D over its first two axes instead
    (``propagate_to_edge_sharded``)."""
    keys = cam_dict['keys']
    if keys.size == 0:
        if dataset.startswith('DeepGlobe'):
            return np.full((orig_hw[0] // 4, orig_hw[1] // 4), 5, np.uint8)
        return np.zeros(orig_hw, np.uint8)
    dev = resolve_device(device)
    cam = torch.as_tensor(cam_dict['cam'], dtype=torch.float32, device=dev)
    edge = torch.as_tensor(edge).to(dev, torch.float32)
    if dataset.startswith('DeepGlobe'):
        # extra downsample before the walk (make_sem_seg_labels.py:101-104)
        h6 = max(cam.shape[1] // walk_downsample, 4)
        w6 = max(cam.shape[2] // walk_downsample, 4)
        cam = resize_bilinear(cam.permute(1, 2, 0)[None],
                              (h6, w6))[0].permute(2, 0, 1)
    if tuple(edge.shape) != tuple(cam.shape[1:]):
        edge = resize_bilinear(edge[None, ..., None], cam.shape[1:])[0, ..., 0]
    if mesh is not None:
        rw = propagate_to_edge_sharded(cam, edge, mesh, beta=beta,
                                       exp_times=exp_times, radius=5)
    else:
        rw = propagate_to_edge(cam, edge, beta=beta, exp_times=exp_times,
                               radius=5)
    rw_hwc = rw.permute(1, 2, 0)[None]
    if dataset == 'VOC2012':
        keys_pad = np.pad(keys + 1, (1, 0), mode='constant')
        rw_up = resize_bilinear(rw_hwc, orig_hw)[0]
        rw_up = rw_up / torch.max(rw_up)
        rw_bg = torch.cat([torch.full(tuple(orig_hw) + (1,),
                                      sem_seg_bg_thres, device=dev), rw_up],
                          dim=-1)
        # torch.argmax takes the first of tied maxima, as jnp.argmax does
        pred = torch.argmax(rw_bg, dim=-1).cpu().numpy()
        return keys_pad[pred].astype(np.uint8)
    if dataset.startswith('DeepGlobe'):
        out_hw = (orig_hw[0] // 4, orig_hw[1] // 4)
    else:
        out_hw = orig_hw
    rw_up = resize_bilinear(rw_hwc, out_hw)[0]
    rw_up = rw_up / torch.max(rw_up)
    pred = torch.argmax(rw_up, dim=-1).cpu().numpy()
    return keys[pred].astype(np.uint8)
