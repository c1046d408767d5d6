"""Evaluation metrics of the port (counterpart of
``wsss_tpu/eval/metrics.py``): segmentation confusion / IoU, the
streaming intersect/union accumulators, the batch F1 metric and the ROC
optimal-threshold calibration.

The functions take tensors (on any device) or numpy arrays.  Device work
stays on the inputs' device; what the reference computes on the host in
float64 (IoU, precision/recall, the thresholded metrics) comes back as
numpy float64 here too.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
    conf = _host(conf).astype(np.float64)
    inter = np.diag(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    iou = inter / np.maximum(union, 1e-12)
    present = union > 0
    miou = float(np.sum(np.where(present, iou, 0.0))
                 / max(int(np.sum(present)), 1))
    return iou, miou


def precision_recall_from_confusion(conf) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class precision/recall (03b_irn/step/eval_cam.py:96-103), on
    the host in float64."""
    conf = _host(conf).astype(np.float64)
    inter = np.diag(conf)
    prec = inter / np.maximum(conf.sum(0), 1e-12)
    rec = inter / np.maximum(conf.sum(1), 1e-12)
    return prec, rec


def iou_update(inter, union, pred_onehot, gt_onehot
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming per-class intersect/union accumulation.

    pred_onehot/gt_onehot: bool [..., C]; matches the accumulators at
    02_cues/adp_cues.py:304-339 and 03a model.py:698-719.  Returns int64
    tensors on the one-hots' device."""
    pred_onehot = torch.as_tensor(pred_onehot)
    gt_onehot = torch.as_tensor(gt_onehot, device=pred_onehot.device)
    dims = tuple(range(pred_onehot.ndim - 1))
    inter = torch.as_tensor(inter, device=pred_onehot.device) + torch.sum(
        pred_onehot & gt_onehot, dim=dims)
    union = torch.as_tensor(union, device=pred_onehot.device) + torch.sum(
        pred_onehot | gt_onehot, dim=dims)
    return inter, union


def batch_f1(y_true, y_pred, eps: float = 1e-7) -> torch.Tensor:
    """Batch-wise F1 on rounded predictions (01_train/utilities.py:69-97);
    a float32 scalar tensor on y_pred's device."""
    y_pred = torch.as_tensor(y_pred, dtype=torch.float32)
    y_true = torch.as_tensor(y_true, dtype=torch.float32,
                             device=y_pred.device)
    y_pred_r = torch.round(torch.clamp(y_pred, 0, 1))
    tp = torch.sum(torch.round(torch.clamp(y_true * y_pred_r, 0, 1)))
    possible = torch.sum(torch.round(torch.clamp(y_true, 0, 1)))
    predicted = torch.sum(y_pred_r)
    recall = tp / (possible + eps)
    precision = tp / (predicted + eps)
    return 2 * precision * recall / (precision + recall + eps)


def _threshold_grid(num_thresholds: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, num_thresholds)`` bit for bit in float32: the
    reference's grid is iota times the float32 reciprocal of
    (num_thresholds - 1), XLA's form of its division, then 1.0."""
    div = num_thresholds - 1
    step = torch.tensor(1.0, dtype=torch.float32) / div
    grid = torch.arange(div, dtype=torch.float32) * step
    return torch.cat([grid, torch.ones(1)]).to(device)


def _roc_stats(target: torch.Tensor, scores: torch.Tensor,
               num_thresholds: int = 512):
    """TPR/FPR over a fixed grid of thresholds, vectorized over classes.

    target/scores: [N, C].  Returns (tprs, fprs, thresholds) each
    [num_thresholds, C].  Grid-based rather than sklearn's exact ROC: for
    score distributions produced by sigmoid heads the optimal
    sensitivity=specificity crossing matches within grid resolution.
    """
    th = _threshold_grid(num_thresholds, scores.device)[:, None, None]
    pred = scores[None] >= th                                   # [T,N,C]
    pos = target[None] > 0.5
    tp = torch.sum(pred & pos, dim=1).to(torch.float32)
    fp = torch.sum(pred & ~pos, dim=1).to(torch.float32)
    npos = torch.clamp(torch.sum(pos[0], dim=0), min=1).to(torch.float32)
    nneg = torch.clamp(torch.sum(~pos[0], dim=0), min=1).to(torch.float32)
    return tp / npos, fp / nneg, th[:, 0, 0, None].expand(tp.shape)


def optimal_thresholds(target, scores, num_thresholds: int = 512
                       ) -> torch.Tensor:
    """Per-class optimal score threshold where sensitivity == specificity.

    Mirrors 01_train/utilities.py:99-114 (argmin |TPR - (1 - FPR)|, the
    first grid point on ties).  Returns float32 [C] on scores' device."""
    scores = torch.as_tensor(scores, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=scores.device)
    tprs, fprs, ths = _roc_stats(target, scores, num_thresholds)
    idx = torch.argmin(torch.abs(tprs - (1.0 - fprs)), dim=0)
    return torch.gather(ths, 0, idx[None])[0]


def thresholded_metrics(target, scores, thresholds) -> Dict[str, np.ndarray]:
    """Per-class TPR/FPR/TNR/FNR/ACC/F1 (01_train/utilities.py:118-143),
    on the host in float64."""
    target = _host(target)
    pred = _host(scores) >= _host(thresholds)
    cond_p = np.sum(target == 1, 0)
    cond_n = np.sum(target == 0, 0)
    tp = np.sum((target == 1) & pred, 0)
    fp = np.sum((target == 0) & pred, 0)
    tn = np.sum((target == 0) & ~pred, 0)
    fn = np.sum((target == 1) & ~pred, 0)
    with np.errstate(divide='ignore', invalid='ignore'):
        out = dict(
            tpr=tp / cond_p, fpr=fp / cond_n, tnr=tn / cond_n,
            fnr=fn / cond_p,
            acc=np.sum(target == pred, 0) / pred.shape[0],
            f1=(2 * tp) / (2 * tp + fp + fn))
    return out
