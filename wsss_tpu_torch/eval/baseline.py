"""Published reference mIoU tables (the parity targets) of the port: its
own copy of ``wsss_tpu/eval/baseline.py``.

Transcribed from the reference README.md:145-155 (also BASELINE.md):
"train on Training, evaluate on Testing" per dataset, one table per
classifier seed family (VGG16 vs X1.7-for-ADP / M7-for-VOC+DeepGlobe).
Keys: (dataset, eval_split, model, method) -> published mIoU.

Known drift: the reference README itself notes SEC/DSRG
DeepGlobe_balanced numbers differ slightly from the paper due to a
retrain during code cleanup (README.md:143).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

METHODS = ('Grad-CAM', 'SEC', 'DSRG', 'IRNet', 'HistoSegNet')

# (dataset, eval_split) -> {family: (gradcam, sec, dsrg, irnet, hsn)}
_TABLE = {
    ('ADP-morph', 'tuning'): {
        'VGG16': (0.14507, 0.10730, 0.08826, 0.15068, 0.13255),
        'X1.7':  (0.20997, 0.13597, 0.13458, 0.21450, 0.27546),
    },
    ('ADP-morph', 'evaluation'): {
        'VGG16': (0.14946, 0.11409, 0.08011, 0.15546, 0.16159),
        'X1.7':  (0.21426, 0.13369, 0.10835, 0.21737, 0.26156),
    },
    ('ADP-func', 'tuning'): {
        'VGG16': (0.34813, 0.28232, 0.37193, 0.35016, 0.44215),
        'X1.7':  (0.35233, 0.32216, 0.28625, 0.34730, 0.50663),
    },
    ('ADP-func', 'evaluation'): {
        'VGG16': (0.38187, 0.28097, 0.44726, 0.36318, 0.44115),
        'X1.7':  (0.37910, 0.30828, 0.31734, 0.38943, 0.48020),
    },
    ('VOC2012', 'val'): {
        'VGG16': (0.26262, 0.37058, 0.32129, 0.31198, 0.22707),
        'M7':    (0.14946, 0.37629, 0.35004, 0.17844, 0.09201),
    },
    ('DeepGlobe', 'test'): {
        'VGG16': (0.28037, 0.24005, 0.28841, 0.29405, 0.24019),
        'M7':    (0.21260, 0.24841, 0.35258, 0.24620, 0.29398),
    },
    ('DeepGlobe_balanced', 'test'): {
        'VGG16': (0.28083, 0.25512, 0.32017, 0.29207, 0.30410),
        'M7':    (0.22266, 0.20050, 0.26470, 0.21303, 0.21617),
    },
}


def published_miou(dataset: str, split: str, model: str,
                   method: str) -> Optional[float]:
    """Published mIoU for one (dataset, eval split, model, method), or
    None when the reference publishes no number for the combination."""
    fam = _TABLE.get((dataset, split))
    if fam is None or model not in fam:
        return None
    try:
        return fam[model][METHODS.index(method)]
    except ValueError:
        return None


def alt_model(dataset: str) -> str:
    """The non-VGG16 seed family for a dataset (README.md:147)."""
    return 'X1.7' if dataset.startswith('ADP') else 'M7'


def eval_splits(dataset: str) -> Tuple[str, ...]:
    """Published evaluation splits per dataset."""
    if dataset.startswith('ADP'):
        return ('tuning', 'evaluation')
    if dataset.startswith('DeepGlobe'):
        return ('test',)
    return ('val',)


def all_rows() -> Dict[Tuple[str, str, str, str], float]:
    """Flat {(dataset, split, model, method): miou} of every published
    number (70 entries)."""
    out = {}
    for (ds, split), fams in _TABLE.items():
        for model, vals in fams.items():
            for m, v in zip(METHODS, vals):
                out[(ds, split, model, m)] = v
    return out
