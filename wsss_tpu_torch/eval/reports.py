"""Evaluation artifact writers of the port (counterpart of
``wsss_tpu/eval/reports.py``): colorized masks, overlays and the
per-class IoU csv.

Ported so far: what the cue CLI writes — ``colorize``, ``overlay``,
``save_png`` and ``write_iou_csv`` (the csv; the reference also writes an
.xlsx sibling, which waits with the xlsx, ROC and heatmap writers in
ROADMAP queue 1 item 3).
"""
from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

import numpy as np


def colorize(labels: np.ndarray, palette: np.ndarray,
             ignore_label: int = 255,
             ignore_color=(0, 0, 0)) -> np.ndarray:
    """Index map [H,W] -> RGB uint8 via the dataset palette.  The ignore
    label renders black by default; cam_to_ir_label.py:87-88 renders its
    255 mid-confidence pixels WHITE — pass ignore_color=(255,)*3 there."""
    pal = np.asarray(palette, np.uint8)
    out = np.zeros(labels.shape + (3,), np.uint8)
    out[...] = np.asarray(ignore_color, np.uint8)
    valid = labels != ignore_label
    out[valid] = pal[np.clip(labels[valid], 0, len(pal) - 1)]
    return out


def overlay(img: np.ndarray, color_mask: np.ndarray,
            r: float = 0.75) -> np.ndarray:
    """(1-r)*img + r*mask (make_sem_seg_labels.py:135-138); r per dataset:
    VOC 0.75, DeepGlobe 0.25 (02_cues/demo.py:368-371)."""
    return np.uint8((1 - r) * np.float32(img) + r * np.float32(color_mask))


def save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    Image.fromarray(arr).save(path)


def write_iou_csv(path: str, class_names: Sequence[str], iou: np.ndarray,
                  precision: Optional[np.ndarray] = None,
                  recall: Optional[np.ndarray] = None) -> float:
    """Per-class IoU (+P/R) csv with a final mIoU row, in the
    reference's columns; returns mIoU (the nan-mean of iou)."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    miou = float(np.nanmean(iou))
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        header = ['class', 'iou'] + \
            (['precision', 'recall'] if precision is not None else [])
        w.writerow(header)
        for i, name in enumerate(class_names):
            row = [name, f'{float(iou[i]):.5f}']
            if precision is not None:
                row += [f'{float(precision[i]):.5f}',
                        f'{float(recall[i]):.5f}']
            w.writerow(row)
        w.writerow(['miou', f'{miou:.5f}'])
    return miou
