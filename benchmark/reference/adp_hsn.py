"""HistoSegNet on ADP from ``adp_x17_hsn``'s file, plain: normalize -> the
X1.7 classifier -> confidence-scaled Grad-CAM -> the 31 valid classes ->
the morph and func unaries (the synthetic background and other-tissue
channels, then class-specific Grad-CAM) -> the two mean fields on the
truncated window.  Written from the method's description
(lyndonchan/wsss-analysis ``03c_hsn/utilities.py``), independent of the
program.

  * X1.7: the M7 trunk (``nets.vgg_classifier``'s features), a global max
    over space, the dense head, a sigmoid.
  * Grad-CAM weights [F, C], input-independent: from a zero image (not
    normalized), the gradient of each class's pre-sigmoid logit through
    the global max to the final activations (a maximum held by several
    positions shares the gradient evenly, as TensorFlow's reduce_max
    does), divided by its RMS plus 1e-5 and averaged over space.
  * A CAM is ReLU(resize(feats @ weights)) divided by its image's maximum
    (at least 1e-7), scaled by score * (score >= class_threshold), then
    the 31 valid classes picked from the 51 outputs (``x17_to_31``).
  * The synthetic channels (``modify_by_htt``): background
    background_max * sigmoid(glass_slope * (mean RGB - glass_level)),
    blurred by a Gaussian of blur_sigma (truncated at blur_truncate
    sigmas, the edge mirrored with its sample repeated), less the largest
    activation of the exception classes; func's other channel
    max(other_tissue_mult * (1 - max over its channels), the largest
    adipose activation of morph).
  * Class-specific Grad-CAM: at each pixel the largest channel keeps the
    difference to the second largest, the others 0; func's other channel
    passes through.
  * Mean field: as ``crf.mean_field`` (symmetric normalization, the self
    term removed, Q <- softmax(log p + g_compat m_g + bi_compat m_b), p
    clamped at 1e-10), the bilateral kernel on the truncated window: the
    offsets (dy, dx) with dy^2 + dx^2 <= (radius_sxy bi_sxy)^2, each
    applied on its own with the weight map
    ws exp(-|I(p) - I(p + d)|^2 / 2 srgb^2), ws = exp(-|d|^2 / 2 sxy^2),
    and zero outside the image.

Departures from ``03c_hsn/utilities.py``: the images stay at the
classifier's 224^2 (the reference resizes ADP's 1088^2 patches on the host
first); the bilateral kernel is the exact truncated window where
pydensecrf approximates it on a permutohedral lattice; the messages are
normalized symmetrically (pydensecrf normalizes by rows); no argmax or
colour map is taken (the posteriors are compared).

In 'tf32' mode the window's operands (x and the weight maps) are rounded
to TF32 on the card as on the CPU: TF32 touches only products that go to
the tensor cores, so without the rounding the control would leave the
window in float32."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import crf as crf_ref
from benchmark.reference import nets
from benchmark.reference.hsn import normalize
from benchmark.reference.numerics import Numerics, tf32_round


def classifier(num: Numerics, cfg: dict, layers: Sequence, x):
    """(scores [B, C], final activations [B, h, w, F])."""
    _, feats = nets.vgg_classifier(num, cfg, layers, x)
    return torch.sigmoid(head_logits(num, layers, feats)), feats


def head_logits(num: Numerics, layers: Sequence, feats):
    w, b = layers[-1]
    return num.linear(torch.amax(feats, dim=(1, 2)), w, b)


def gradcam_weights(num: Numerics, cfg: dict, layers: Sequence):
    s = cfg['input_size']
    dev = layers[0][0].device
    with torch.no_grad():
        _, feats = classifier(num, cfg, layers,
                              torch.zeros((1, s, s, 3), device=dev))
    feats = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = head_logits(num, layers, feats)[0]
        rows = []
        for c in range(logits.shape[0]):
            (g,) = torch.autograd.grad(logits[c], feats, retain_graph=True)
            g = g / (torch.sqrt(torch.mean(g * g)) + 1e-5)
            rows.append(g[0].mean(dim=(0, 1)))
    return torch.stack(rows, 1).detach()


def gaussian_blur(x: torch.Tensor, sigma: float, truncate: float):
    """[B, H, W] blurred along each axis by the normalized 1-D Gaussian of
    radius int(truncate sigma + 0.5), the edge mirrored with its sample
    repeated (-1 -> 0, n -> n - 1)."""
    r = int(truncate * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    for axis in (1, 2):
        n = x.shape[axis]
        i = np.arange(-r, n + r) % (2 * n)
        src = torch.as_tensor(np.where(i < n, i, 2 * n - 1 - i),
                              device=x.device)
        xp = x.index_select(axis, src)
        out = 0
        for t in range(2 * r + 1):
            out = out + float(k[t]) * xp.narrow(axis, t, n)
        x = out
    return x


def synthetic_channels(cfg: dict, cams: torch.Tensor, imgs: torch.Tensor,
                       exceptions: Sequence[int], other: int = None,
                       adipose=None) -> torch.Tensor:
    """cams [B, H, W, C] with channel 0 (and ``other``) set."""
    htt = cfg['htt']
    bg = htt['background_max'] * torch.sigmoid(
        htt['glass_slope'] * (imgs.float().mean(-1) - htt['glass_level']))
    bg = gaussian_blur(bg, htt['blur_sigma'], htt['blur_truncate'])
    bg = bg - cams[..., list(exceptions)].amax(-1)
    out = cams.clone()
    out[..., 0] = bg
    if other is not None:
        o = htt['other_tissue_mult'] * (1.0 - out.amax(-1))
        out[..., other] = torch.maximum(o, adipose)
    return out


def class_specific(cams: torch.Tensor, other: int = None) -> torch.Tensor:
    top = torch.topk(cams, 2, dim=-1).values
    win = F.one_hot(cams.argmax(-1), cams.shape[-1]).to(cams.dtype)
    out = (top[..., 0] - top[..., 1])[..., None] * win
    if other is not None:
        out[..., other] = cams[..., other]
    return out


class Window:
    """The truncated bilateral window of guides [B, H, W, 3] (0..255):
    one weight map [B, H, W] an offset, kept for the filters."""

    def __init__(self, num: Numerics, imgs: torch.Tensor, sxy: float,
                 srgb: float, radius_sxy: float, reverse: bool = False):
        rad = radius_sxy * sxy
        n = int(math.ceil(rad))
        offs = [(dy, dx) for dy in range(-n, n + 1)
                for dx in range(-n, n + 1) if dy * dy + dx * dx <= rad * rad]
        self.offs = offs[::-1] if reverse else offs
        self.n, self.num = n, num
        b, h, w, _ = imgs.shape
        img_p = F.pad(imgs.float(), (0, 0, n, n, n, n))
        inside = F.pad(torch.ones((b, h, w), device=imgs.device),
                       (n, n, n, n))
        maps = []
        for dy, dx in self.offs:
            ys, xs = slice(n + dy, n + dy + h), slice(n + dx, n + dx + w)
            d2 = ((imgs.float() - img_p[:, ys, xs]) ** 2).sum(-1)
            ws = float(np.float32(np.exp(-0.5 * (dy * dy + dx * dx)
                                         / (sxy * sxy))))
            maps.append(ws * torch.exp(-d2 * (0.5 / (srgb * srgb)))
                        * inside[:, ys, xs])
        self.maps = torch.stack(maps)
        if num.mode == 'tf32':
            self.maps = tf32_round(self.maps)

    def filter(self, x: torch.Tensor) -> torch.Tensor:
        """K @ x of x [B, H, W, C], the offsets summed in their order."""
        if self.num.mode == 'tf32':
            x = tf32_round(x)
        n = self.n
        b, h, w, _ = x.shape
        x_p = F.pad(x, (0, 0, n, n, n, n))
        acc = torch.zeros_like(x)
        for k, (dy, dx) in enumerate(self.offs):
            acc = acc + self.maps[k][..., None] * x_p[:, n + dy:n + dy + h,
                                                      n + dx:n + dx + w]
        return acc


def mean_field(num: Numerics, probs: torch.Tensor, imgs: torch.Tensor,
               crf: dict, radius_sxy: float, reverse: bool = False
               ) -> torch.Tensor:
    """The posterior Q [B, H, W, C] of unaries probs on guides imgs."""
    b, h, w, c = probs.shape
    logp = torch.log(torch.clamp(probs.float(), min=1e-10))
    q = torch.softmax(logp, dim=-1)
    win = Window(num, imgs, crf['bi_sxy'], crf['bi_srgb'], radius_sxy,
                 reverse)
    ones = torch.ones((b, h, w, 1), device=probs.device)
    n_b = torch.rsqrt(torch.clamp(win.filter(ones), min=1e-20))
    n_g = torch.rsqrt(torch.clamp(crf_ref.gaussian_filter(num, ones,
                                                          crf['g_sxy']),
                                  min=1e-20))
    for _ in range(crf['iterations']):
        m_g = n_g * crf_ref.gaussian_filter(num, n_g * q, crf['g_sxy']) \
            - n_g * n_g * q
        m_b = n_b * win.filter(n_b * q) - n_b * n_b * q
        q = torch.softmax(logp + (crf['g_compat'] * m_g
                                  + crf['bi_compat'] * m_b), dim=-1)
    return q


class ADPHSNReference:
    def __init__(self, num: Numerics, cfg: dict, layers: Sequence):
        self.num, self.cfg, self.layers = num, cfg, layers
        self.weights = gradcam_weights(num, cfg, layers)
        c31 = cfg['classes_31']
        self.morph = [c31.index(c) for c in cfg['morph_classes']]
        self.func = [c31.index(c) for c in cfg['func_classes']]
        morph_seg = ['Background'] + cfg['morph_classes']
        func_seg = ['Background', 'Other'] + cfg['func_classes']
        self.morph_exc = [morph_seg.index(c)
                          for c in cfg['morph_bg_exceptions']]
        self.adipose = [morph_seg.index(c) for c in cfg['adipose_classes']]
        self.func_exc = [func_seg.index(c) for c in cfg['func_bg_exceptions']]

    @torch.no_grad()
    def probs(self, imgs: torch.Tensor):
        """imgs [B, S, S, 3] float 0..255 -> the unaries (morph
        [B, S, S, 29], func [B, S, S, 5])."""
        cfg, s = self.cfg, self.cfg['input_size']
        scores, feats = classifier(self.num, cfg, self.layers,
                                   normalize(cfg['norm'], imgs))
        cams = self.num.einsum('bhwf,fc->bhwc', feats, self.weights)
        cams = torch.relu(crf_ref.resize_bilinear(cams, (s, s)))
        cams = cams / torch.clamp(cams.amax(dim=(1, 2, 3), keepdim=True),
                                  min=1e-7)
        scale = scores * (scores >= cfg['class_threshold']).float()
        cams31 = (cams * scale[:, None, None, :])[..., cfg['x17_to_31']]
        b = cams31.shape[0]
        morph = torch.zeros((b, s, s, 1 + len(self.morph)),
                            device=imgs.device)
        morph[..., 1:] = cams31[..., self.morph]
        morph = synthetic_channels(cfg, morph, imgs, self.morph_exc)
        func = torch.zeros((b, s, s, 2 + len(self.func)), device=imgs.device)
        func[..., 2:] = cams31[..., self.func]
        func = synthetic_channels(cfg, func, imgs, self.func_exc, other=1,
                                  adipose=morph[..., self.adipose].amax(-1))
        return class_specific(morph), class_specific(func, other=1)

    @torch.no_grad()
    def crf(self, key: str, probs: torch.Tensor, imgs: torch.Tensor,
            reverse: bool = False) -> torch.Tensor:
        """The posterior of the CRF ``key`` ('crf_morph' or 'crf_func')."""
        return mean_field(self.num, probs, imgs.float(), self.cfg[key],
                          self.cfg['window']['radius_sxy'], reverse)
