"""Dataset metadata the port's HistoSegNet slice needs (a copy of the
JAX package's registry entries for VOC2012 and DeepGlobe).

Plain-python static metadata: class lists, palettes and the
normalization tables of the reference's cue stack."""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np

Color = Tuple[int, int, int]

PALETTES: Mapping[str, Tuple[Color, ...]] = {
    'VOC2012': (
        (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
        (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0),
        (192, 0, 0), (64, 128, 0), (192, 128, 0), (64, 0, 128),
        (192, 0, 128), (64, 128, 128), (192, 128, 128), (0, 64, 0),
        (128, 64, 0), (0, 192, 0), (128, 192, 0), (0, 64, 128)),
    'DeepGlobe': (
        (0, 255, 255), (255, 255, 0), (255, 0, 255), (0, 255, 0),
        (0, 0, 255), (255, 255, 255), (0, 0, 0)),
}

VOC_CLASS_NAMES: Tuple[str, ...] = (
    '__background__', 'aeroplane', 'bicycle', 'bird', 'boat', 'bottle',
    'bus', 'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
    'motorbike', 'person', 'pottedplant', 'sheep', 'sofa', 'train',
    'tvmonitor')

DEEPGLOBE_CLASS_NAMES: Tuple[str, ...] = (
    'urban', 'agriculture', 'rangeland', 'forest', 'water', 'barren')


@dataclasses.dataclass(frozen=True)
class Normalization:
    """Per-stack image normalization. ``x_norm = (x*scale - mean) / std``
    then ``* post_scale``."""
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    scale: float = 1.0  # applied before mean-subtract
    post_scale: float = 1.0  # applied after (VOC 02_cues: mean-sub then /255)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Static description of one WSSS benchmark."""
    name: str
    seg_class_names: Tuple[str, ...]   # segmentation classes incl. synthetic
    fg_class_names: Tuple[str, ...]    # classifier-supervised classes
    n_bg_channels: int            # synthetic channels prepended (bg / other)
    palette: Tuple[Color, ...]
    clf_size_vgg16: int = 321     # classifier input (VGG16 family)
    clf_size_m7: int = 224        # classifier input (M7 / X1.7 family)
    seed_size: int = 41           # cue/seed grid for SEC/DSRG
    gt_size: int = 0              # full-res GT (0 = same as image)
    norm_cues: Normalization = Normalization((0.0, 0.0, 0.0))
    norm_sec: Normalization = Normalization((0.0, 0.0, 0.0))
    norm_irn: Normalization = Normalization((0.0, 0.0, 0.0))
    has_bg_class: bool = True     # segmentation includes a background channel
    uses_bg_net: bool = False     # VOC cue-gen uses a second bg network
    ignore_label: int = 255

    @property
    def n_seg_classes(self) -> int:
        return len(self.seg_class_names)

    @property
    def n_fg_classes(self) -> int:
        return len(self.fg_class_names)

    def palette_array(self) -> np.ndarray:
        return np.asarray(self.palette, dtype=np.uint8)


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

VOC2012 = DatasetSpec(
    name='VOC2012',
    seg_class_names=VOC_CLASS_NAMES,
    fg_class_names=VOC_CLASS_NAMES[1:],
    n_bg_channels=1,
    palette=PALETTES['VOC2012'],
    # 02_cues/utilities.py:178-180: BGR-order means subtracted from
    # RGB-read channels (a reference quirk, kept), then 1/255
    norm_cues=Normalization(mean=(104.0, 117.0, 123.0), post_scale=1 / 255.),
    norm_sec=Normalization(mean=(104.00698793, 116.66876762, 122.67891434)),
    norm_irn=Normalization(
        mean=tuple(255 * m for m in _IMAGENET_MEAN),
        std=tuple(255 * s for s in _IMAGENET_STD)),
    uses_bg_net=True,
)

DEEPGLOBE = DatasetSpec(
    name='DeepGlobe',
    seg_class_names=DEEPGLOBE_CLASS_NAMES,
    fg_class_names=DEEPGLOBE_CLASS_NAMES,
    n_bg_channels=0,
    palette=PALETTES['DeepGlobe'][:6],
    gt_size=2448,
    # 02_cues/dataset.py:91-96 (1/255 only)
    norm_cues=Normalization(mean=(0., 0., 0.), scale=1 / 255.),
    norm_sec=Normalization(mean=(0., 0., 0.)),
    norm_irn=Normalization(mean=(0., 0., 0.), std=(255., 255., 255.)),
    has_bg_class=False,
)

DEEPGLOBE_BALANCED = dataclasses.replace(DEEPGLOBE, name='DeepGlobe_balanced')

REGISTRY: Mapping[str, DatasetSpec] = {
    s.name: s for s in (VOC2012, DEEPGLOBE, DEEPGLOBE_BALANCED)}


def get(name: str) -> DatasetSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f'Unknown dataset {name!r}; known: {sorted(REGISTRY)}') from None
