"""Evaluation artifact writers of the port (a copy of
``wsss_tpu/eval/reports.py``): colorized masks, overlays, IoU and metric
tables with their xlsx siblings, confusion heatmaps, ROC plots and the
cross-method results aggregator.

Covers the reference's outputs: colorized prediction PNGs + overlays
(02_cues/demo.py:466-477, make_sem_seg_labels.py:121-140), per-class IoU
csv (eval_cam.py:110-111, eval_sem_seg.py:60-61), metric tables
(01_train/utilities.py:181-222 — csv + a reference-schema xlsx sibling
via the stdlib writer in :mod:`wsss_tpu_torch.eval.xlsx`),
confusion heatmaps (01_train/utilities.py:223-284, 03a model.py:746-779),
and scripts/extract_eval.py:1-100 (the method x dataset mIoU table,
aggregating both csv and reference xlsx outputs).  PIL and matplotlib
are imported by the functions that use them.
"""
from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from wsss_tpu_torch.eval import xlsx


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


def save_color_and_overlay(out_dir: str, name: str, labels: np.ndarray,
                           palette: np.ndarray,
                           img: Optional[np.ndarray] = None,
                           r: float = 0.75,
                           ignore_label: int = 255,
                           ignore_color=(0, 0, 0)) -> None:
    """Write `{name}.png` (palette-colorized labels) and, when the original
    image is given, `{name}_overlay.png` — the debug-artifact pair every
    reference step emits (eval_cam.py:66-85, cam_to_ir_label.py:79-93,
    make_sem_seg_labels.py:121-140, 03a model.py:588-612).  The color mask
    is nearest-resized to the image geometry when they differ
    (eval_cam.py:80-82)."""
    color = colorize(labels, palette, ignore_label, ignore_color)
    save_png(os.path.join(out_dir, name + '.png'), color)
    if img is None:
        return
    if img.shape[:2] != color.shape[:2]:
        from PIL import Image as _Image
        color = np.asarray(_Image.fromarray(color).resize(
            (img.shape[1], img.shape[0]), _Image.NEAREST))
    save_png(os.path.join(out_dir, name + '_overlay.png'),
             overlay(np.asarray(img, np.float32), color, r))


def write_iou_csv(path: str, class_names: Sequence[str], iou: np.ndarray,
                  precision: Optional[np.ndarray] = None,
                  recall: Optional[np.ndarray] = None) -> float:
    """Per-class IoU (+P/R) csv with a final mIoU row; returns mIoU.

    Also writes a sibling `.xlsx` in the reference's `df.to_excel` schema
    (Class/IoU[/Precision/Recall] columns + 'Mean' row,
    03a_sec-dsrg/model.py:740-745, 03c_hsn/demo.py:233-238) so
    pandas-based reference consumers parse our outputs unchanged."""
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
    table = {'Class': list(class_names) + ['Mean'],
             'IoU': [float(v) for v in iou] + [miou]}
    if precision is not None:
        table['Precision'] = [float(v) for v in precision] + \
            [float(np.nanmean(precision))]
        table['Recall'] = [float(v) for v in recall] + \
            [float(np.nanmean(recall))]
    xlsx.write_table_xlsx(os.path.splitext(path)[0] + '.xlsx', table)
    return miou


def write_metrics_csv(path: str, class_names: Sequence[str],
                      metrics: Dict[str, np.ndarray]) -> None:
    """Thresholded classification metrics table
    (01_train/utilities.py:181-222 semantics, csv format).

    Also writes the reference's xlsx layout alongside (HTT column,
    per-metric columns, 'Average' row — utilities.py:181-193)."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['class'] + list(metrics))
        for i, name in enumerate(class_names):
            w.writerow([name] + [f'{float(v[i]):.5f}'
                                 for v in metrics.values()])
    table = {'HTT': list(class_names) + ['Average']}
    for key, vals in metrics.items():
        table[key] = [float(v) for v in vals] + [float(np.nanmean(vals))]
    xlsx.write_table_xlsx(os.path.splitext(path)[0] + '.xlsx', table)


def confusion_heatmap(path: str, conf: np.ndarray,
                      class_names: Sequence[str],
                      normalize: bool = True) -> None:
    """Row-normalized confusion heatmap PNG (utilities.py:223-284)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    conf = np.asarray(conf, np.float64)
    if normalize:
        conf = conf / np.maximum(conf.sum(1, keepdims=True), 1e-12)
    fig, ax = plt.subplots(
        figsize=(max(4, len(class_names) * 0.4),) * 2)
    im = ax.imshow(conf, cmap='viridis')
    ax.set_xticks(range(len(class_names)))
    ax.set_yticks(range(len(class_names)))
    ax.set_xticklabels(class_names, rotation=90, fontsize=6)
    ax.set_yticklabels(class_names, fontsize=6)
    ax.set_xlabel('Predicted')
    ax.set_ylabel('Ground truth')
    fig.colorbar(im)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_rocs(path: str, target: np.ndarray, scores: np.ndarray,
              class_names: Sequence[str],
              num_thresholds: int = 256) -> None:
    """Per-class ROC curves PNG (01_train/utilities.py:167-179)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    th = np.linspace(0, 1, num_thresholds)[:, None, None]
    pred = scores[None] >= th
    pos = target[None] > 0.5
    tp = (pred & pos).sum(1)
    fp = (pred & ~pos).sum(1)
    tpr = tp / np.maximum(pos[0].sum(0), 1)
    fpr = fp / np.maximum((~pos[0]).sum(0), 1)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot([0, 1], [0, 1], 'k--', lw=0.5)
    for i, name in enumerate(class_names):
        ax.plot(fpr[:, i], tpr[:, i], lw=0.8, label=name)
    ax.set_xlabel('FPR')
    ax.set_ylabel('TPR')
    if len(class_names) <= 24:
        ax.legend(fontsize=5, ncol=2)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def extract_eval(eval_root: str) -> List[Dict[str, str]]:
    """Aggregate all `*_iou.csv` mIoU rows under eval_root into one table
    (scripts/extract_eval.py:1-100).  Returns list of
    {method, run, miou} rows, printed as a DataFrame by the CLI.

    Also aggregates reference-format xlsx metric tables (the Class/IoU +
    'Mean'-row layout `df.to_excel` emits, read at extract_eval.py:20-25,
    93-96), so a mixed tree of our csv outputs and reference xlsx outputs
    collates into one table.  Our own `.xlsx` siblings of `_iou.csv`
    files are skipped to avoid double counting."""
    rows = []
    for dirpath, _, files in os.walk(eval_root):
        present = set(files)
        for fn in sorted(files):
            rel = os.path.relpath(dirpath, eval_root)
            if fn.endswith('_iou.csv'):
                with open(os.path.join(dirpath, fn)) as f:
                    for line in f:
                        m = re.match(r'miou,([0-9.]+)', line.strip())
                        if m:
                            rows.append({'run': os.path.join(rel, fn),
                                         'miou': m.group(1)})
            elif fn.endswith('.xlsx') and not fn.startswith('~'):
                stem = os.path.splitext(fn)[0]
                if stem + '.csv' in present:   # our own csv sibling
                    continue
                miou = xlsx.table_mean_value(os.path.join(dirpath, fn))
                if miou is not None:
                    rows.append({'run': os.path.join(rel, fn),
                                 'miou': f'{miou:.5f}'})
    return rows
