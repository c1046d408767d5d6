"""Grid mean field of one image with its rows banded over a mesh
(counterpart of ``wsss_tpu/ops/crf/mxu_sharded.py``).

The reference downsamples DeepGlobe's 2448^2 images before every pairwise
step because one GPU cannot hold them (cam_to_ir_label.py:61,
make_sem_seg_labels.py:101-104).  Here the pixel rows are banded over the
mesh instead: the bilateral grid's spatial reach is bounded (spatial blur
radius + 1 bilinear cell, in tiles of t px), so each shard owns a band of
tile rows plus a halo of 2x that reach, refreshed once an iteration.
Output rows need the right ``n * Q`` up to the reach, and the symmetric
normalizer of a contributing row reads another reach.

Each band builds its own ``MXUBilateralGrid`` on the extended band, so the
grid's kernels run unchanged on every band: on the v2 route
``bilateral_splat`` (K1), ``bilateral_color_blur`` (K2) and
``bilateral_slice`` (K3), once for the normalizer and once an iteration.
The grid samples colour at cells of srgb (cell_mult 1) and the full
resolution, as the reference's does here.

Two departures, both on purpose:
  * geometry: the reference passes ``require8=not interpret``; the port
    takes the TPU's 8-aligned spatial cells everywhere, as its ``_mxu_ok``
    does (so bi_sxy 3 runs in the reference's interpret mode only);
  * precision: the reference's Gaussian message rounds its operands to
    bf16 (mxu_sharded.py:135-137) and its grid kernels work in bf16; the
    port stays in float32, and ``ref_round=True`` rounds at the same
    points (the Gaussian's operands; the grid's plain versions as
    ``MXUBilateralGrid(ref_round=True)`` does), a CPU-test switch.
"""
from __future__ import annotations

import numpy as np
import torch

from wsss_tpu_torch.ops.crf import mxu_grid as _mxu
from wsss_tpu_torch.ops.crf.meanfield import _gaussian_filter_raw
from wsss_tpu_torch.ops.crf.sharded import _exchange_halo as _exchange_rows


def _halo_px(sxy: float) -> tuple:
    """(cell t, halo pixels): halo = 2 x the kernel's reach, the reach
    (spatial blur radius + 1 bilinear cell) tiles of t px, following the
    grid's sub-cell spatial sampling (cell = sxy/k, 8-aligned)."""
    t, k = _mxu._spatial_cell(sxy, True)
    rad = max(2, int(np.ceil(3.0 * np.sqrt(k * k - 1.0 / 3.0))))
    return t, 2 * (rad + 1) * t


def mean_field_sharded(probs: torch.Tensor, img: torch.Tensor, config,
                       mesh, axis: str = 'data', exclude_self: bool = True,
                       ref_round: bool = False) -> torch.Tensor:
    """Mean field on ONE full-resolution image with its rows banded over
    mesh axis ``axis``; probs [H,W,C], img [H,W,3].  H is padded to a
    multiple of shards x t; padded rows send no message.  Needs a
    grid-applicable config (integer, 8-aligned cell) and a band of at
    least the halo per shard.  Returns Q [H,W,C] float32 on the first
    shard's device."""
    h, w = probs.shape[:2]
    c = probs.shape[-1]
    if not _mxu.applicable(config.bi_sxy, config.bi_srgb, c, require8=True):
        raise ValueError('config not MXU-grid applicable')
    t, halo = _halo_px(config.bi_sxy)
    ndev = mesh.shape[axis]
    hp = -(-h // (ndev * t)) * (ndev * t)
    rows = hp // ndev
    if rows < halo:
        raise ValueError(
            f'{rows} rows/shard < halo {halo}; use fewer shards')

    def pad_rows(x):
        return torch.nn.functional.pad(x.to(torch.float32),
                                       (0, 0, 0, 0, 0, hp - h))

    probs = pad_rows(probs)
    img = pad_rows(img)
    valid = pad_rows(torch.ones((h, w, 1), device=probs.device))
    devs = mesh.axis_devices(axis)

    def bands(x):
        return [x[i * rows:(i + 1) * rows].to(d)
                for i, d in enumerate(devs)]

    # static geometry: the guide image and the validity cross once
    img_e = _exchange_rows(bands(img), halo)
    v_e = [v[None] for v in _exchange_rows(bands(valid), halo)]
    u_e = [u[None] for u in _exchange_rows(
        bands(-torch.log(torch.clamp(probs, min=1e-10))), halo)]
    grids, n_b, n_g = [], [], []
    for i in range(ndev):
        grids.append(_mxu.MXUBilateralGrid(
            img_e[i][None], config.bi_sxy, config.bi_srgb, c,
            ref_round=ref_round))
        n_b.append(torch.rsqrt(torch.clamp(grids[i].filter(v_e[i]),
                                           min=1e-20)))
        if config.g_compat:
            n_g.append(torch.rsqrt(torch.clamp(
                _gaussian_filter_raw(v_e[i], config.g_sxy), min=1e-20)))

    inner = slice(halo, halo + rows)
    q_loc = [torch.softmax(-u[0, inner] + torch.amax(u[0, inner], -1,
                                                     keepdim=True), -1)
             for u in u_e]
    for _ in range(config.iterations):
        q_e = [q[None] for q in _exchange_rows(q_loc, halo)]
        new = []
        for i in range(ndev):
            # message INPUTS masked by validity: padded rows (h not a
            # multiple of shards x t) must not send messages into valid
            # rows; the normalizers alone fix only the denominator
            msg = 0.
            if config.g_compat:
                m = n_g[i] * _gaussian_filter_raw(n_g[i] * q_e[i] * v_e[i],
                                                  config.g_sxy,
                                                  ref_round=ref_round)
                if exclude_self:
                    m = m - (n_g[i] * n_g[i]) * q_e[i]
                msg = msg + config.g_compat * m
            m = n_b[i] * grids[i].filter(n_b[i] * q_e[i] * v_e[i])
            if exclude_self:
                m = m - (n_b[i] * n_b[i]) * q_e[i]
            msg = msg + config.bi_compat * m
            new.append(torch.softmax(-u_e[i] + msg, dim=-1)[0, inner])
        q_loc = new
    return torch.cat([q.to(devs[0]) for q in q_loc])[:h]
