"""Host-side data pipeline of the port (a copy of
``wsss_tpu/data/pipeline.py``): devkit loaders + synthetic fixtures.

One loader family replaces the reference's four (Keras ImageDataGenerator
02_cues/dataset.py, tf.data 03a model.py:157-348, torch Datasets
03b dataloaders, trimmed copies in 03c).  Host work is IO + decode +
augmentation (per-image numpy/PIL); normalization runs on the device
(``methods``).

Loop semantics match the reference's loaders:
  * per-epoch shuffling (Keras generators, tf.data .shuffle at 03a
    model.py:279, DataLoader shuffle=True at train_irn.py:81-82) via
    ``batches(shuffle=True)`` — a fresh permutation per epoch,
    reproducible from ``seed``.
  * training augmentation via ``augment=f(img, gt, rng)``.
  * IO/compute overlap via :func:`prefetch` — the replacement for
    tf.data prefetch / DataLoader num_workers (SURVEY.md §2.8 row 4).
  * native-size iteration (``iter_native``) for the 03b inference steps,
    which keep original image geometry (make_cam.py:41-42) instead of
    the classifier's square resize.

When no devkit is on disk, :class:`SyntheticWSSS`
fabricates a deterministic dataset with the same interface — images whose
GT segmentation is derivable (colored blobs), so end-to-end pipelines and
benchmarks run without the real data.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Callable, Iterator, List, Optional

import numpy as np

from wsss_tpu_torch.data.registry import DatasetSpec, get as get_spec

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

AugmentFn = Callable[[np.ndarray, Optional[np.ndarray],
                      np.random.Generator],
                     tuple]


def prefetch(it, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue.

    Overlaps host IO/decode/augment with device compute — the stand-in
    for tf.data's .prefetch / DataLoader workers (the reference
    uses num_workers=mp.cpu_count()//4, train_irn.py:81-82)."""
    q: 'queue.Queue' = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # surfaced on the consumer side
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


@dataclasses.dataclass
class Batch:
    """One host batch. Arrays are numpy; the consumer copies them to its
    device."""
    indices: np.ndarray          # [B] global image indices
    names: List[str]
    images: np.ndarray           # [B,H,W,3] float32 RGB 0..255 (unnorm)
    tags: np.ndarray             # [B,C_fg] image-level labels (0/1)
    gt: Optional[np.ndarray] = None      # [B,Hg,Wg] int32 seg labels or None


def packaged_split_path(dataset: str, split: str) -> Optional[str]:
    """Path to a shipped reference split list, or None.

    The reference distributes its exact evaluation protocol as data
    (03b_irn/voc12/*.txt — train_aug 10,582 / val 1,449 —, adp/*.txt,
    deepglobe/*.txt); these ship under wsss_tpu_torch/data/splits/ so the
    published splits work on a devkit that lacks ImageSets/."""
    family = ('voc12' if dataset == 'VOC2012' else
              'adp' if dataset.startswith('ADP') else 'deepglobe')
    if family == 'adp' and split == 'segtest':
        split = 'evaluation'   # 02_cues' name for 03b's evaluation set
    path = os.path.join(os.path.dirname(__file__), 'splits', family,
                        split + '.txt')
    return path if os.path.exists(path) else None


class DevkitDataset:
    """Reads a reference-layout devkit (VOCdevkit / ADPdevkit / DGdevkit).

    Directory conventions follow 02_cues/dataset.py:98-126 and the 03b
    dataloaders; images resized to `size` at load.
    """

    def __init__(self, spec: DatasetSpec, root: str, split: str, size: int,
                 htt: Optional[str] = None, seed: int = 0):
        if Image is None:
            raise RuntimeError('PIL unavailable')
        self.spec, self.root, self.split, self.size = spec, root, split, size
        self.htt = htt
        self.seed = seed
        self._epoch = 0
        self.names, self.tags = self._read_split()

    # --- layout ----------------------------------------------------------
    def _dirs(self):
        name = self.spec.name
        if name == 'VOC2012':
            base = os.path.join(self.root, 'VOCdevkit', 'VOC_trainaug_val',
                                'VOC2012')
            return (os.path.join(base, 'JPEGImages'),
                    os.path.join(base, 'SegmentationClassAug'),
                    os.path.join(base, 'ImageSets', 'Segmentation'))
        if name.startswith('ADP'):
            base = os.path.join(self.root, 'ADPdevkit', 'ADPRelease1')
            sub = 'ADP-' + (self.htt or name.split('-')[-1])
            return (os.path.join(base, 'PNGImagesSubset'),
                    os.path.join(base, 'SegmentationClassAug', sub),
                    os.path.join(base, 'ImageSets', 'Segmentation'))
        base = os.path.join(self.root, 'DGdevkit')
        return (os.path.join(base, 'JPEGImages'),
                os.path.join(base, 'SegmentationClassAug'),
                os.path.join(base, 'ImageSets', 'Segmentation'))

    def _read_split(self):
        img_dir, _, split_dir = self._dirs()
        txt = os.path.join(split_dir, self.split + '.txt')
        csv = os.path.join(split_dir, self.split + '.csv')
        names: List[str] = []
        tags = None
        if os.path.exists(csv):
            import csv as _csv
            with open(csv) as f:
                rows = list(_csv.reader(f))
            header, rows = rows[0], rows[1:]
            names = [r[0] for r in rows]
            tags = np.asarray([[float(v) for v in r[1:]] for r in rows],
                              np.float32)
        elif os.path.exists(txt):
            with open(txt) as f:
                names = [ln.strip().split(' ')[0] for ln in f
                         if ln.strip()]
        else:
            # packaged reference split lists (03b_irn/{voc12,adp,
            # deepglobe}/*.txt ship with the wheel) so a stock devkit
            # without ImageSets/ still runs the published protocol —
            # but only when the devkit's image tree actually exists
            # (an absent devkit must still fall back to synthetic).
            shipped = (packaged_split_path(self.spec.name, self.split)
                       if os.path.isdir(img_dir) else None)
            if shipped is None:
                raise FileNotFoundError(f'no split list {txt} / {csv}')
            with open(shipped) as f:
                names = [ln.strip().split(' ')[0] for ln in f
                         if ln.strip()]
        if tags is None:
            tags = self._resolve_tags(names, split_dir)
        if tags is None:
            tags = np.zeros((len(names), self.spec.n_fg_classes),
                            np.float32)
        return names, tags

    def _resolve_tags(self, names, split_dir):
        """Tags for txt-only splits, in the reference's resolution
        order: cls_labels.npy cache (make_cls_labels family), VOC
        Annotations XML, classes present in the GT masks."""
        from wsss_tpu_torch.data import cls_labels as _cl
        tags = _cl.load_cache(split_dir, self.split, names)
        if tags is not None:
            return tags
        img_dir, gt_dir, _ = self._dirs()
        if self.spec.name == 'VOC2012':
            ann = os.path.join(os.path.dirname(img_dir), 'Annotations')
            tags = _cl.tags_from_voc_xml(ann, names,
                                         self.spec.fg_class_names)
            if tags is not None:
                return tags
        gt_paths = [os.path.join(gt_dir,
                                 os.path.splitext(n)[0] + '.png')
                    for n in names]
        return _cl.tags_from_gt(gt_paths, self.spec.n_fg_classes,
                                self.spec.n_bg_channels)

    def __len__(self):
        return len(self.names)

    def split_tags(self) -> np.ndarray:
        """All image-level tags [N, C_fg] (for class weighting,
        01_train/demo.py:80)."""
        return self.tags

    def _load_img(self, name: str, native: bool = False) -> np.ndarray:
        img_dir, _, _ = self._dirs()
        path = os.path.join(img_dir, name)
        if not os.path.splitext(name)[1]:
            for ext in ('.jpg', '.png'):
                if os.path.exists(path + ext):
                    path += ext
                    break
        im = Image.open(path).convert('RGB')
        if not native and im.size != (self.size, self.size):
            im = im.resize((self.size, self.size), Image.BILINEAR)
        return np.asarray(im, np.float32)

    def _load_gt(self, name: str) -> Optional[np.ndarray]:
        _, gt_dir, _ = self._dirs()
        base = os.path.splitext(name)[0]
        path = os.path.join(gt_dir, base + '.png')
        if not os.path.exists(path):
            return None
        im = Image.open(path)
        arr = np.asarray(im)
        if arr.ndim == 2:        # palettized index labels (VOC)
            return arr.astype(np.int32)
        # RGB color-coded GT (ADP / DeepGlobe): decode via palette
        pal = self.spec.palette_array().astype(np.int32)
        flat = arr[..., :3].reshape(-1, 3).astype(np.int32)
        d = np.abs(flat[:, None, :] - pal[None]).sum(-1)
        return d.argmin(1).reshape(arr.shape[:2]).astype(np.int32)

    def _order(self, shuffle: bool) -> np.ndarray:
        order = np.arange(len(self.names))
        if shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(order)
            self._epoch += 1
        return order

    def batches(self, batch_size: int, with_gt: bool = False,
                shuffle: bool = False,
                augment: Optional[AugmentFn] = None) -> Iterator[Batch]:
        order = self._order(shuffle)
        arng = np.random.default_rng((self.seed + 1, self._epoch)) \
            if augment else None
        for s in range(0, len(order), batch_size):
            idx = order[s:s + batch_size]
            names = [self.names[i] for i in idx]
            imgs = [self._load_img(nm) for nm in names]
            gts = [self._load_gt(nm) for nm in names] if with_gt else None
            if gts is not None and any(g is None for g in gts):
                gts = None
            if augment:
                for i in range(len(imgs)):
                    g = gts[i] if gts is not None else None
                    imgs[i], g = augment(imgs[i], g, arng)
                    if gts is not None:
                        gts[i] = g
            yield Batch(indices=idx,
                        names=names, images=np.stack(imgs),
                        tags=self.tags[idx],
                        gt=np.stack(gts) if gts is not None else None)

    def iter_native(self, with_gt: bool = False) -> Iterator[Batch]:
        """Single-image batches at ORIGINAL size (aspect preserved) — the
        03b inference contract (per-image .npy shapes, make_cam.py:41-42).
        Wrap in :func:`prefetch` to overlap decode with device compute."""
        for i, nm in enumerate(self.names):
            img = self._load_img(nm, native=True)
            gt = self._load_gt(nm) if with_gt else None
            yield Batch(indices=np.array([i]), names=[nm],
                        images=img[None], tags=self.tags[i:i + 1],
                        gt=None if gt is None else gt[None])


class SyntheticWSSS:
    """Deterministic synthetic dataset with derivable GT.

    Images are composed of colored rectangles, one color per class; the GT
    mask is the rectangle layout; image-level tags are the classes present.
    Class 0 renders as the background color when the spec has a background
    class.
    """

    def __init__(self, spec: DatasetSpec | str, size: int = 64,
                 n_images: int = 32, seed: int = 0):
        self.spec = get_spec(spec) if isinstance(spec, str) else spec
        self.size = size
        self.n = n_images
        self.seed = seed
        self._epoch = 0
        # distinct render colors per seg class (palette itself, jittered)
        self.colors = self.spec.palette_array().astype(np.float32)

    def __len__(self):
        return self.n

    def split_tags(self) -> np.ndarray:
        return np.stack([self._gen_one(i)[1] for i in range(self.n)])

    def _gen_one(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        c_seg = self.spec.n_seg_classes
        nbg = self.spec.n_bg_channels
        gt = np.zeros((self.size, self.size), np.int32)
        n_obj = rng.integers(1, 4)
        present = rng.choice(np.arange(nbg, c_seg),
                             size=min(n_obj, c_seg - nbg), replace=False)
        for cls in present:
            h = rng.integers(self.size // 5, self.size // 2)
            w = rng.integers(self.size // 5, self.size // 2)
            y = rng.integers(0, self.size - h)
            x = rng.integers(0, self.size - w)
            gt[y:y + h, x:x + w] = cls
        img = self.colors[gt].astype(np.float32)
        img += rng.normal(0, 6, img.shape).astype(np.float32)
        img = np.clip(img, 0, 255)
        tags = np.zeros((self.spec.n_fg_classes,), np.float32)
        for cls in np.unique(gt):
            if cls >= nbg:
                tags[cls - nbg] = 1.0
        return img, tags, gt

    def batches(self, batch_size: int, with_gt: bool = True,
                shuffle: bool = False,
                augment: Optional[AugmentFn] = None) -> Iterator[Batch]:
        order = np.arange(self.n)
        if shuffle:
            rng = np.random.default_rng((self.seed + 7, self._epoch))
            rng.shuffle(order)
            self._epoch += 1
        arng = np.random.default_rng((self.seed + 8, self._epoch)) \
            if augment else None
        for s in range(0, self.n, batch_size):
            idx = order[s:s + batch_size]
            items = [self._gen_one(int(i)) for i in idx]
            imgs, tags, gts = (list(z) for z in zip(*items))
            if augment:
                for i in range(len(imgs)):
                    g = gts[i] if with_gt else None
                    imgs[i], g = augment(imgs[i], g, arng)
                    if with_gt:
                        gts[i] = g
            yield Batch(indices=idx,
                        names=[f'synth_{int(i):05d}' for i in idx],
                        images=np.stack(imgs), tags=np.stack(tags),
                        gt=np.stack(gts) if with_gt else None)

    def iter_native(self, with_gt: bool = False) -> Iterator[Batch]:
        """Native-size iteration; synthetic images vary size around the
        nominal so bucketed-inference paths are exercised."""
        for i in range(self.n):
            rng = np.random.default_rng((self.seed + 9, i))
            img, tags, gt = self._gen_one(i)
            # non-square jitter: crop a random margin off one axis
            dh = int(rng.integers(0, max(self.size // 4, 1)))
            dw = int(rng.integers(0, max(self.size // 4, 1)))
            img, gt = img[dh:], gt[dh:]
            img, gt = img[:, dw:], gt[:, dw:]
            yield Batch(indices=np.array([i]),
                        names=[f'synth_{i:05d}'], images=img[None],
                        tags=tags[None],
                        gt=gt[None] if with_gt else None)


def open_dataset(spec_name: str, data_root: Optional[str], split: str,
                 size: int, synthetic_n: int = 32, htt: Optional[str] = None):
    """Devkit if present on disk, else synthetic (same interface)."""
    spec = get_spec(spec_name)
    if data_root:
        try:
            return DevkitDataset(spec, data_root, split, size, htt=htt)
        except (FileNotFoundError, RuntimeError):
            pass
    return SyntheticWSSS(spec, size=size, n_images=synthetic_n)
