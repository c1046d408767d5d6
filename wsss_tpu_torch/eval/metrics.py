"""Segmentation confusion and IoU (counterpart of the first part of
``wsss_tpu/eval/metrics.py``; the ROC calibration and F1 metrics of that
module are not ported yet)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, num_classes: int,
                     ignore_label: int = 255) -> torch.Tensor:
    """Confusion matrix [num_classes, num_classes] (int64) of one image;
    rows = gt, cols = pred, on the tensors' device.

    Pixels whose gt equals ``ignore_label`` or lies outside
    [0, num_classes) are dropped (chainercv's semantics); predictions are
    clipped into range."""
    pred = pred.reshape(-1).long()
    gt = gt.reshape(-1).long()
    valid = (gt != ignore_label) & (gt >= 0) & (gt < num_classes)
    # invalid pixels go to an extra bin that is cut off
    flat = torch.where(valid,
                       gt * num_classes + pred.clamp(0, num_classes - 1),
                       num_classes * num_classes)
    counts = torch.bincount(flat, minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def accumulate_confusion(conf_acc: np.ndarray, pred: torch.Tensor,
                         gt: torch.Tensor, num_classes: int,
                         ignore_label: int = 255) -> np.ndarray:
    """Add one image's confusion into a host int64 accumulator."""
    c = confusion_matrix(pred, gt, num_classes, ignore_label)
    return conf_acc + c.cpu().numpy().astype(np.int64)


def iou_from_confusion(conf) -> Tuple[np.ndarray, float]:
    """Per-class IoU and mIoU from a confusion matrix (tensor or array),
    on the host in float64.  mIoU averages over the classes whose union
    is non-zero."""
    if isinstance(conf, torch.Tensor):
        conf = conf.cpu().numpy()
    conf = np.asarray(conf).astype(np.float64)
    inter = np.diag(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    iou = inter / np.maximum(union, 1e-12)
    present = union > 0
    miou = float(np.sum(np.where(present, iou, 0.0))
                 / max(int(np.sum(present)), 1))
    return iou, miou
