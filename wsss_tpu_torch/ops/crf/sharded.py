"""Dense-CRF mean field with the image rows banded over a mesh, on the
exact windowed bilateral structure (counterpart of
``wsss_tpu/ops/crf/sharded.py``).

The reference handles DeepGlobe's 2448x2448 images by downsampling before
every pairwise step (cam_to_ir_label.py:61, make_sem_seg_labels.py:101-104)
because one GPU cannot hold them.  Both the spatial Gaussian and the
windowed bilateral kernel couple pixels within a fixed radius only, so
each shard owns a band of rows and needs ``halo`` rows of its neighbours
per mean-field iteration: the reference exchanges them with ``ppermute``,
the port copies them between the shards' devices.

The reference's choices are kept: the radii ``r_b = ceil(3 bi_sxy)`` and
``r_g = max(1, ceil(4 g_sxy))``, the halo ``2 max(r_b, r_g)``, its own
truncated separable Gaussian with zero fill (not meanfield's band
matrices), the exchanged ones that carry the border's validity.  Every
iteration computes each band's message from the previous Q of all bands,
then exchanges.  One departure that changes no value: the symmetric
normalizers depend on the guide image only, so each band computes them
once, where the reference recomputes them every iteration.  No hand
kernel runs here; the reference has none either.
"""
from __future__ import annotations

import numpy as np
import torch


def _exchange_halo(xs: list, halo: int) -> list:
    """Per-shard bands [rows, ...] (shard order) -> [halo+rows+halo, ...]
    with the neighbours' rows; edge shards receive zero rows (zero fill at
    the image borders).  Each extended band is a new tensor (``cat``): a
    received halo is never written, so shards that share a device never
    see each other's rows change."""
    out = []
    for i, x in enumerate(xs):
        zeros = x.new_zeros((halo,) + tuple(x.shape[1:]))
        up = (xs[i - 1][-halo:].to(x.device, non_blocking=True) if i > 0
              else zeros)
        down = (xs[i + 1][:halo].to(x.device, non_blocking=True)
                if i < len(xs) - 1 else zeros)
        out.append(torch.cat([up, x, down], 0))
    return out


def _gauss_raw(x: torch.Tensor, kg: list, r: int) -> torch.Tensor:
    """Unnormalized separable Gaussian with taps kg over the two leading
    axes of x [R, W, C], zero fill: taps added in order along rows, then
    along columns (the reference's shard_fn ``raw``)."""
    n0, n1 = x.shape[:2]
    p = torch.nn.functional.pad(x, (0, 0, r, r, r, r))
    o = 0.
    for i in range(2 * r + 1):
        o = o + kg[i] * p[i:i + n0]
    p2 = o
    o = 0.
    for i in range(2 * r + 1):
        o = o + kg[i] * p2[:, i:i + n1]
    return o


def _window_raw(x: torch.Tensor, img: torch.Tensor, ones: torch.Tensor,
                offs, wspace, srgb: float) -> torch.Tensor:
    """K x on a halo-extended band [R, W, .]: for each offset (in the
    reference's order) its spatial weight times the colour weight times
    the shifted validity, times the shifted x; zero fill past the band
    (the arrays are padded once and each shift is a view)."""
    n0, n1 = x.shape[:2]
    r = max(max(abs(dy), abs(dx)) for dy, dx in offs)

    def pad(t):
        return torch.nn.functional.pad(t, (0, 0, r, r, r, r))

    x_p, img_p, ones_p = pad(x), pad(img), pad(ones)
    out = torch.zeros_like(x)
    inv2s2 = 0.5 / (srgb * srgb)
    for (dy, dx), ws in zip(offs, wspace):
        ys, xs = slice(r + dy, r + dy + n0), slice(r + dx, r + dx + n1)
        d_i2 = torch.sum((img - img_p[ys, xs]) ** 2, dim=-1)
        wm = ws * torch.exp(-d_i2 * inv2s2) * ones_p[ys, xs, 0]
        out.addcmul_(wm[..., None], x_p[ys, xs])
    return out


def mean_field_sharded(probs: torch.Tensor, img: torch.Tensor, config,
                       mesh, axis: str = 'data',
                       exclude_self: bool = True) -> torch.Tensor:
    """Full-resolution mean field of ONE image with its rows banded over
    mesh axis ``axis``; probs [H,W,C], img [H,W,3].  The shard count must
    divide H.  Exact windowed bilateral (radius 3 bi_sxy) and windowed
    Gaussian.  Returns Q [H,W,C] float32 on the first shard's device."""
    h, w, c = probs.shape
    nsh = mesh.shape[axis]
    if h % nsh:
        raise AssertionError(f'H={h} must divide mesh axis {axis}={nsh}')
    r_b = int(np.ceil(3.0 * config.bi_sxy))
    r_g = max(1, int(np.ceil(4.0 * config.g_sxy)))
    # 2x the kernel radius: symmetric normalization needs n_j = 1/sqrt(K 1)_j
    # for every neighbour j of an interior pixel, and n_j reads one radius
    # further out
    halo = 2 * max(r_b, r_g)
    rows = h // nsh
    if halo > rows:
        raise AssertionError(f'halo {halo} exceeds shard height {rows}; '
                             'use fewer shards')

    offs, wspace = [], []
    for dy in range(-r_b, r_b + 1):
        for dx in range(-r_b, r_b + 1):
            d2 = dy * dy + dx * dx
            if d2 <= (3.0 * config.bi_sxy) ** 2:
                offs.append((dy, dx))
                wspace.append(float(np.exp(-0.5 * d2 / (config.bi_sxy ** 2))))
    kg = [float(v) for v in np.exp(
        -0.5 * (np.arange(-r_g, r_g + 1) / config.g_sxy) ** 2
    ).astype(np.float32)]

    devs = mesh.axis_devices(axis)
    probs_s = [probs[i * rows:(i + 1) * rows].to(d, torch.float32)
               for i, d in enumerate(devs)]
    img_s = [img[i * rows:(i + 1) * rows].to(d, torch.float32)
             for i, d in enumerate(devs)]
    U = [-torch.log(torch.clamp(p, min=1e-10)) for p in probs_s]
    Q = [torch.softmax(-u, dim=-1) for u in U]
    ones_h = _exchange_halo(
        [torch.ones((rows, w, 1), device=d) for d in devs], halo)
    img_h = _exchange_halo(img_s, halo)

    def norm(raw):
        return torch.rsqrt(torch.clamp(raw, min=1e-20))

    if config.g_compat:
        n_g = [norm(_gauss_raw(o, kg, r_g)) for o in ones_h]
    if config.bi_compat:
        n_b = [norm(_window_raw(o, i, o, offs, wspace, config.bi_srgb))
               for o, i in zip(ones_h, img_h)]

    def message(n, raw_nq, q_h):
        out = n * raw_nq
        if exclude_self:
            out = out - n * n * q_h
        return out[halo:-halo]

    for _ in range(config.iterations):
        Q_h = _exchange_halo(Q, halo)
        new = []
        for i in range(nsh):
            msg = 0.
            if config.g_compat:
                m = message(n_g[i], _gauss_raw(n_g[i] * Q_h[i], kg, r_g),
                            Q_h[i])
                msg = msg + config.g_compat * m
            if config.bi_compat:
                m = message(n_b[i], _window_raw(
                    n_b[i] * Q_h[i], img_h[i], ones_h[i], offs, wspace,
                    config.bi_srgb), Q_h[i])
                msg = msg + config.bi_compat * m
            new.append(torch.softmax(-U[i] + msg, dim=-1))
        Q = new
    return torch.cat([q.to(devs[0]) for q in Q])
