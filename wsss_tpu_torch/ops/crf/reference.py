"""Exact O(N^2) dense-CRF mean-field in numpy — the executable spec.

A copy of ``wsss_tpu/ops/crf/reference.py`` (numpy only): the ground
truth the port's structures are validated against on tiny inputs.
It implements Krähenbühl & Koltun (NIPS'11) mean-field with Potts
compatibility and symmetric kernel normalization — the algorithm behind
pydensecrf's DenseCRF2D as used at 03c_hsn/utilities.py:399-445 — by
materializing the full pairwise kernel matrices.  Never used on real-size
images.
"""
from __future__ import annotations

import numpy as np


def _kernel_matrices(img: np.ndarray, g_sxy: float, bi_sxy: float,
                     bi_srgb: float):
    """Full [N,N] Gaussian and bilateral kernels for an [H,W,3] image."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    pos = np.stack([xx.ravel(), yy.ravel()], axis=1).astype(np.float64)
    rgb = img.reshape(-1, 3).astype(np.float64)

    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    kg = np.exp(-d2 / (2 * g_sxy ** 2))
    kb = np.exp(-d2 / (2 * bi_sxy ** 2)
                - ((rgb[:, None] - rgb[None]) ** 2).sum(-1)
                / (2 * bi_srgb ** 2))
    return kg, kb


def _sym_message(K: np.ndarray, Q: np.ndarray, exclude_self: bool):
    """Symmetric-normalized filtered message: n * (K @ (n * Q)), with the
    self term (k(i,i)=1 -> n_i^2 Q_i) removed when exclude_self."""
    n = 1.0 / np.sqrt(K.sum(axis=1))
    out = n[:, None] * (K @ (n[:, None] * Q))
    if exclude_self:
        out = out - (n ** 2)[:, None] * Q
    return out


def mean_field_exact(probs: np.ndarray, img: np.ndarray, config,
                     exclude_self: bool = True) -> np.ndarray:
    """Exact mean-field. probs: [H,W,C]; img: [H,W,3] (0..255).

    Update: Q <- softmax(-U + sum_m compat_m * message_m(Q)), U = -log(p).
    Returns final Q [H,W,C].
    """
    g_sxy, g_compat, bi_sxy, bi_srgb, bi_compat, iters = config.astuple()
    h, w, c = probs.shape
    kg, kb = _kernel_matrices(img, g_sxy, bi_sxy, bi_srgb)
    U = -np.log(np.clip(probs.reshape(-1, c), 1e-10, None))
    Q = np.exp(-U)
    Q /= Q.sum(-1, keepdims=True)
    for _ in range(iters):
        msg = (g_compat * _sym_message(kg, Q, exclude_self)
               + bi_compat * _sym_message(kb, Q, exclude_self))
        logits = -U + msg
        logits -= logits.max(-1, keepdims=True)
        Q = np.exp(logits)
        Q /= Q.sum(-1, keepdims=True)
    return Q.reshape(h, w, c)
