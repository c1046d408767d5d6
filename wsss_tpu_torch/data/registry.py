"""Dataset metadata of the port (a copy of the JAX package's registry:
VOC2012, DeepGlobe and the ADP taxonomy with its morph / func specs).

Plain-python static metadata: class lists, palettes, the normalization
tables of the reference's stacks and ADP's class-index maps."""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import numpy as np

Color = Tuple[int, int, int]

# ---------------------------------------------------------------------------
# ADP taxonomy (reference: 02_cues/adp_cues.py:27-47)
# ---------------------------------------------------------------------------

ADP_CLASSES_X17: Tuple[str, ...] = (
    'E', 'E.M', 'E.M.S', 'E.M.U', 'E.M.O', 'E.T', 'E.T.S', 'E.T.U', 'E.T.O',
    'E.P', 'C', 'C.D', 'C.D.I', 'C.D.R', 'C.L', 'H', 'H.E', 'H.K', 'H.Y',
    'S', 'S.M', 'S.M.C', 'S.M.S', 'S.E', 'S.C', 'S.C.H', 'S.R', 'A', 'A.W',
    'A.B', 'A.M', 'M', 'M.M', 'M.K', 'N', 'N.P', 'N.R', 'N.R.B', 'N.R.A',
    'N.G', 'N.G.M', 'N.G.A', 'N.G.O', 'N.G.E', 'N.G.R', 'N.G.W', 'N.G.T',
    'G', 'G.O', 'G.N', 'T')

ADP_CLASSES_VGG16: Tuple[str, ...] = (
    'E.M.S', 'E.M.U', 'E.M.O', 'E.T.S', 'E.T.U', 'E.T.O', 'E.P', 'C.D.I',
    'C.D.R', 'C.L', 'H.E', 'H.K', 'H.Y', 'S.M.C', 'S.M.S', 'S.E', 'S.C.H',
    'S.R', 'A.W', 'A.B', 'A.M', 'M.M', 'M.K', 'N.P', 'N.R.B', 'N.R.A',
    'N.G.M', 'N.G.W', 'G.O', 'G.N', 'T')

ADP_MORPH_CLASSES: Tuple[str, ...] = (
    'E.M.S', 'E.M.U', 'E.M.O', 'E.T.S', 'E.T.U', 'E.T.O', 'E.P', 'C.D.I',
    'C.D.R', 'C.L', 'H.E', 'H.K', 'H.Y', 'S.M.C', 'S.M.S', 'S.E', 'S.C.H',
    'S.R', 'A.W', 'A.B', 'A.M', 'M.M', 'M.K', 'N.P', 'N.R.B', 'N.R.A',
    'N.G.M', 'N.G.W')

ADP_FUNC_CLASSES: Tuple[str, ...] = ('G.O', 'G.N', 'T')

ADP_BG_EXCEPTION = {
    # classes whose activation is subtracted from the synthetic Background
    # channel (02_cues/adp_cues.py:270,274)
    'morph': ('A.W', 'A.B', 'A.M'),
    'func': ('G.O', 'G.N', 'T'),
}
ADP_ADIPOSE_CLASSES: Tuple[str, ...] = ('A.W', 'A.B', 'A.M')

PALETTES: Mapping[str, Tuple[Color, ...]] = {
    'ADP-morph': (
        (255, 255, 255), (0, 0, 128), (0, 128, 0), (255, 165, 0),
        (255, 192, 203), (255, 0, 0), (173, 20, 87), (176, 141, 105),
        (3, 155, 229), (158, 105, 175), (216, 27, 96), (244, 81, 30),
        (124, 179, 66), (142, 36, 255), (240, 147, 0), (204, 25, 165),
        (121, 85, 72), (142, 36, 170), (179, 157, 219), (121, 134, 203),
        (97, 97, 97), (167, 155, 142), (228, 196, 136), (213, 0, 0),
        (4, 58, 236), (0, 150, 136), (228, 196, 65), (239, 108, 0),
        (74, 21, 209)),
    'ADP-func': (
        (255, 255, 255), (3, 155, 229), (0, 0, 128), (0, 128, 0),
        (173, 20, 87)),
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

ADP_MORPH = DatasetSpec(
    name='ADP-morph',
    seg_class_names=('Background',) + ADP_MORPH_CLASSES,
    fg_class_names=ADP_MORPH_CLASSES,
    n_bg_channels=1,
    palette=PALETTES['ADP-morph'],
    clf_size_vgg16=321,
    clf_size_m7=224,
    gt_size=1088,
    # 02_cues/dataset.py:28-30 / adp_cues.py:145
    norm_cues=Normalization(mean=(193.09203,) * 3, std=(56.450138,) * 3),
    # 03a model.py:86
    norm_sec=Normalization(mean=(208.8502, 163.2828, 207.1458)),
    norm_irn=Normalization(mean=(193.09203,) * 3, std=(56.450138,) * 3),
)

ADP_FUNC = DatasetSpec(
    name='ADP-func',
    seg_class_names=('Background', 'Other') + ADP_FUNC_CLASSES,
    fg_class_names=ADP_FUNC_CLASSES,
    n_bg_channels=2,
    palette=PALETTES['ADP-func'],
    gt_size=1088,
    norm_cues=Normalization(mean=(193.09203,) * 3, std=(56.450138,) * 3),
    norm_sec=Normalization(mean=(208.8502, 163.2828, 207.1458)),
    norm_irn=Normalization(mean=(193.09203,) * 3, std=(56.450138,) * 3),
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
    s.name: s for s in (VOC2012, ADP_MORPH, ADP_FUNC, DEEPGLOBE,
                        DEEPGLOBE_BALANCED)}


def get(name: str) -> DatasetSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f'Unknown dataset {name!r}; known: {sorted(REGISTRY)}') from None


# ---------------------------------------------------------------------------
# ADP class-index maps (reference: 02_cues/adp_cues.py:43-50,
# 03b_irn/net/common_cam.py:26-29)
# ---------------------------------------------------------------------------

def adp_index_maps(model_family: str) -> Mapping[str, np.ndarray]:
    """Index maps between the classifier output vector and morph/func sets.

    model_family: 'X1.7' (51-way classifier) or 'VGG16' (31-way classifier).
    """
    all_classes: Sequence[str] = (
        ADP_CLASSES_X17 if model_family.upper().startswith('X1')
        else ADP_CLASSES_VGG16)
    out = {}
    out['all'] = np.arange(len(all_classes))
    out['morph'] = np.array(
        [i for i, c in enumerate(all_classes) if c in ADP_MORPH_CLASSES])
    out['func'] = np.array(
        [i for i, c in enumerate(all_classes) if c in ADP_FUNC_CLASSES])
    out['adipose'] = np.array(
        [i for i, c in enumerate(all_classes) if c in ADP_ADIPOSE_CLASSES])
    # indices of X1.7's 51 outputs that correspond to the 31 "valid" ADP
    # classes (03b_irn/net/common_cam.py:27-28)
    out['x17_to_31'] = np.array(
        [i for i, c in enumerate(ADP_CLASSES_X17) if c in ADP_CLASSES_VGG16])
    return out
