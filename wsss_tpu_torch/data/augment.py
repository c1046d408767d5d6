"""Host-side training-data augmentation of the port (a copy of
``wsss_tpu/data/augment.py``: numpy, PIL and scipy, no torch).

Rebuilds the reference's two augmentation families from their observed
behavior (both source modules are imported by the reference but the
misc.imutils module itself is missing from the checkout; semantics below
are re-derived from the call sites):

  * the Keras ImageDataGenerator configs used for classifier/cue training
    (02_cues/dataset.py:32-96): per-dataset flips, and for VOC2012 a
    random shift/zoom/rotate affine with reflect fill
    (02_cues/dataset.py:71-79).
  * the torch-side ``misc.imutils`` family consumed by every 03b
    dataloader (03b_irn/voc12/dataloader.py:136-180,255-321):
    ``random_resize_long``, ``random_scale``, ``random_lr_flip``,
    ``random_crop`` (shared geometry for image/label pairs, padding with
    per-array fill values), ``top_left_crop``, ``pil_rescale``.

All ops are numpy/PIL on the host: they run per-image at load time inside
the input pipeline's prefetch thread (see
:mod:`wsss_tpu_torch.data.pipeline`), keeping augmented shapes static.
Every op takes an explicit ``np.random.Generator`` so epochs are
reproducible from a seed.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

_PIL_ORDER = {0: 'NEAREST', 1: 'BILINEAR', 3: 'BICUBIC'}


def pil_rescale(arr: np.ndarray, scale: float, order: int) -> np.ndarray:
    """Rescale by a factor (imutils.pil_rescale; used for the /4 ir-label
    reduction at voc12/dataloader.py:316)."""
    h, w = arr.shape[:2]
    return pil_resize(arr, (int(round(h * scale)), int(round(w * scale))),
                      order)


def pil_resize(arr: np.ndarray, hw: Tuple[int, int], order: int
               ) -> np.ndarray:
    """Resize to (h, w) with a PIL filter; preserves integer dtypes for
    nearest (labels)."""
    if arr.shape[:2] == tuple(hw):
        return arr
    resample = getattr(Image, _PIL_ORDER[order])
    if arr.ndim == 2:
        src = arr
        if np.issubdtype(arr.dtype, np.integer):
            src = arr.astype(np.int32)   # PIL mode 'I' (no int64 support)
        im = Image.fromarray(src)
        out = im.resize((hw[1], hw[0]), resample)
        return np.asarray(out).astype(arr.dtype)
    chans = []
    src = arr.astype(np.float32)
    for c in range(arr.shape[2]):
        im = Image.fromarray(src[..., c])
        chans.append(np.asarray(im.resize((hw[1], hw[0]), resample)))
    return np.stack(chans, -1).astype(arr.dtype if
                                      np.issubdtype(arr.dtype, np.integer)
                                      else np.float32)


def random_resize_long(img: np.ndarray, min_long: int, max_long: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Resize so the longer side is uniform in [min_long, max_long)
    (imutils.random_resize_long, voc12/dataloader.py:166)."""
    target = int(rng.integers(min_long, max_long))
    h, w = img.shape[:2]
    if w < h:
        scale = target / h
    else:
        scale = target / w
    return pil_resize(img, (int(round(h * scale)), int(round(w * scale))),
                      3)


def random_scale(arrays: Sequence[np.ndarray],
                 scale_range: Tuple[float, float],
                 orders: Sequence[int],
                 rng: np.random.Generator) -> list:
    """Shared random scale factor for an (image, label) pair
    (imutils.random_scale, voc12/dataloader.py:280: order=(3, 0))."""
    s = float(rng.uniform(scale_range[0], scale_range[1]))
    return [pil_rescale(a, s, o) for a, o in zip(arrays, orders)]


def random_lr_flip(arrays: Sequence[np.ndarray],
                   rng: np.random.Generator) -> list:
    """Shared-coin horizontal flip (imutils.random_lr_flip)."""
    if rng.random() < 0.5:
        return [np.ascontiguousarray(a[:, ::-1]) for a in arrays]
    return list(arrays)


def random_ud_flip(arrays: Sequence[np.ndarray],
                   rng: np.random.Generator) -> list:
    """Shared-coin vertical flip (DeepGlobe/ADP ImageDataGenerator
    vertical_flip, 02_cues/dataset.py:41-42,92-94)."""
    if rng.random() < 0.5:
        return [np.ascontiguousarray(a[::-1]) for a in arrays]
    return list(arrays)


def _crop_box(hw: Tuple[int, int], crop: int, rng: Optional[
        np.random.Generator]):
    """Container/content boxes for (possibly padding) crops, shared across
    an image/label pair (imutils.get_random_crop_box semantics)."""
    h, w = hw
    ch, cw = min(crop, h), min(crop, w)
    if rng is not None:
        top = int(rng.integers(0, h - ch + 1))
        left = int(rng.integers(0, w - cw + 1))
        ctop = int(rng.integers(0, crop - ch + 1))
        cleft = int(rng.integers(0, crop - cw + 1))
    else:
        top = left = ctop = cleft = 0
    return (ctop, ctop + ch, cleft, cleft + cw), (top, top + ch,
                                                  left, left + cw)


def _apply_crop(arr: np.ndarray, crop: int, fill, cont, src) -> np.ndarray:
    shape = (crop, crop) + arr.shape[2:]
    out = np.full(shape, fill, arr.dtype)
    out[cont[0]:cont[1], cont[2]:cont[3]] = arr[src[0]:src[1],
                                                src[2]:src[3]]
    return out


def random_crop(arrays: Sequence[np.ndarray], crop: int,
                fills: Sequence, rng: np.random.Generator) -> list:
    """Shared-box random crop with per-array pad fill (imutils.random_crop;
    fills (0, 255) for image/label pairs, voc12/dataloader.py:293)."""
    cont, src = _crop_box(arrays[0].shape[:2], crop, rng)
    return [_apply_crop(a, crop, f, cont, src)
            for a, f in zip(arrays, fills)]


def top_left_crop(arr: np.ndarray, crop: int, fill) -> np.ndarray:
    """Deterministic top-left crop/pad (imutils.top_left_crop,
    voc12/dataloader.py:295-296)."""
    cont, src = _crop_box(arr.shape[:2], crop, None)
    return _apply_crop(arr, crop, fill, cont, src)


def random_affine(img: np.ndarray, rng: np.random.Generator,
                  rotation_deg: float = 0.0, shift_frac: float = 0.0,
                  zoom_frac: float = 0.0, fill_mode: str = 'reflect'
                  ) -> np.ndarray:
    """Keras ImageDataGenerator-style random affine: rotate/shift/zoom
    with reflect fill (the VOC2012 cue-training config,
    02_cues/dataset.py:71-79: shift 0.1, zoom 0.2, rotation 30).

    Matches Keras random_transform composition order
    (rotation @ shift @ zoom, offset so the transform is about the image
    center) with bilinear sampling.
    """
    from scipy import ndimage

    h, w = img.shape[:2]
    theta = np.deg2rad(rng.uniform(-rotation_deg, rotation_deg)) \
        if rotation_deg else 0.0
    tx = rng.uniform(-shift_frac, shift_frac) * h if shift_frac else 0.0
    ty = rng.uniform(-shift_frac, shift_frac) * w if shift_frac else 0.0
    if zoom_frac:
        zx = rng.uniform(1 - zoom_frac, 1 + zoom_frac)
        zy = rng.uniform(1 - zoom_frac, 1 + zoom_frac)
    else:
        zx = zy = 1.0
    m = np.eye(3)
    if theta:
        m = m @ np.array([[np.cos(theta), -np.sin(theta), 0],
                          [np.sin(theta), np.cos(theta), 0], [0, 0, 1]])
    m = m @ np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1.]])
    m = m @ np.array([[zx, 0, 0], [0, zy, 0], [0, 0, 1.]])
    # center the transform
    off = np.array([h / 2.0 - 0.5, w / 2.0 - 0.5])
    offset = off - m[:2, :2] @ off + m[:2, 2]
    out = np.stack([
        ndimage.affine_transform(img[..., c].astype(np.float32),
                                 m[:2, :2], offset=offset, order=1,
                                 mode=fill_mode)
        for c in range(img.shape[2])], -1)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Per-dataset training augmentation policies
# ---------------------------------------------------------------------------

def classifier_augment(dataset_name: str):
    """The reference's per-dataset ImageDataGenerator aug config
    (02_cues/dataset.py:32-96); returns f(img, gt, rng) -> (img, gt).

    gt is flipped with the image when present (so the same policy serves
    FCN-style training); the VOC affine is image-only (cue/classifier
    training has no dense labels in the reference).
    """
    def f(img, gt, rng):
        arrays = [img] if gt is None else [img, gt]
        if dataset_name.startswith(('ADP', 'DeepGlobe')):
            arrays = random_lr_flip(arrays, rng)
            arrays = random_ud_flip(arrays, rng)
        else:  # VOC2012
            arrays = random_lr_flip(arrays, rng)
            if gt is None:
                arrays[0] = random_affine(arrays[0], rng,
                                          rotation_deg=30.0,
                                          shift_frac=0.1, zoom_frac=0.2)
        if gt is None:
            return arrays[0], None
        return arrays[0], arrays[1]
    return f
