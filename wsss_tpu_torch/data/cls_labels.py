"""Image-level label (tag) caches of the port (a copy of
``wsss_tpu/data/cls_labels.py``) — the make_cls_labels family.

The reference ships per-dataset builders that write `cls_labels*.npy`
dicts mapping image name -> multi-hot [C_fg] vector, consumed by every
dataloader: VOC from Annotations XML (03b_irn/voc12/make_cls_labels.py),
ADP from the taxonomy CSVs (adp/make_cls_labels_{morph,func}.py),
DeepGlobe from split CSVs (deepglobe/make_cls_labels_*.py).  Here one
module covers the three sources plus a GT-mask fallback (classes present
in the segmentation PNG), and `data/pipeline.py` resolves tags for
txt-only splits through it.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

try:
    from PIL import Image
except ImportError:          # pragma: no cover
    Image = None

CACHE_NAME = 'cls_labels.npy'


def tags_from_voc_xml(ann_dir: str, names: Sequence[str],
                      fg_classes: Sequence[str]) -> Optional[np.ndarray]:
    """Multi-hot tags from VOC Annotations/<name>.xml object names
    (voc12/make_cls_labels.py semantics).  Returns None if no XML dir."""
    if not os.path.isdir(ann_dir):
        return None
    import xml.etree.ElementTree as ET
    idx = {c: i for i, c in enumerate(fg_classes)}
    out = np.zeros((len(names), len(fg_classes)), np.float32)
    for r, name in enumerate(names):
        stem = os.path.splitext(name)[0]
        path = os.path.join(ann_dir, stem + '.xml')
        if not os.path.exists(path):
            return None
        for obj in ET.parse(path).getroot().iter('object'):
            cls = obj.findtext('name')
            if cls in idx:
                out[r, idx[cls]] = 1.0
    return out


def tags_from_gt(gt_paths: Sequence[str], n_fg: int,
                 n_bg: int = 1) -> Optional[np.ndarray]:
    """Multi-hot tags from classes present in index-label GT masks
    (foreground ids follow the background ids)."""
    if Image is None:
        return None
    out = np.zeros((len(gt_paths), n_fg), np.float32)
    for r, path in enumerate(gt_paths):
        if not os.path.exists(path):
            return None
        arr = np.asarray(Image.open(path))
        if arr.ndim == 3:
            return None          # RGB-coded GT needs the palette decoder
        for cls in np.unique(arr):
            fg = int(cls) - n_bg
            if 0 <= fg < n_fg:
                out[r, fg] = 1.0
    return out


def load_cache(split_dir: str, split: str,
               names: Sequence[str]) -> Optional[np.ndarray]:
    """Read a cls_labels cache (reference .npy dict contract: name ->
    multi-hot vector); per-split file wins over the shared one."""
    for fname in (f'cls_labels_{split}.npy', CACHE_NAME):
        path = os.path.join(split_dir, fname)
        if not os.path.exists(path):
            continue
        d = np.load(path, allow_pickle=True).item()
        rows = []
        for name in names:
            stem = os.path.splitext(name)[0]
            v = d.get(name, d.get(stem))
            if v is None:
                return None
            rows.append(np.asarray(v, np.float32))
        return np.stack(rows)
    return None


def save_cache(split_dir: str, names: Sequence[str], tags: np.ndarray,
               split: Optional[str] = None) -> str:
    """Write the reference-format dict cache."""
    d: Dict[str, np.ndarray] = {
        os.path.splitext(n)[0]: tags[i].astype(np.float32)
        for i, n in enumerate(names)}
    fname = CACHE_NAME if split is None else f'cls_labels_{split}.npy'
    path = os.path.join(split_dir, fname)
    np.save(path, d, allow_pickle=True)
    return path
