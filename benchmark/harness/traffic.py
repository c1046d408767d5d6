"""The one generator of the benchmark's traffic, driven by the parameters
of a ``workloads/<traffic>.json`` file.

Images are flat-coloured square blocks plus Gaussian noise, so the CRF
has edges to follow; they are drawn on the device from the seed in a few
calls and kept on the host as pageable uint8 numpy, as a data loader
hands them over.  Calls draw from the pool in a seeded order, and every
seed sends the same multiset of sizes: only the order changes.

Parameters (keys of the traffic file):
  pool        images in the pool (each size gets pool / len(sizes))
  sizes       [[H, W], ...] image sizes
  block       block side in pixels
  colors      colours per image
  noise       standard deviation of the noise, in 0..255 units
  batch       images a call
  seed_grid, tags, cue_keep   training cues (``train_cues``)
  host_threads  intra-op CPU threads of the run's process (unset: torch's
              default; applied by ``runner.main``)
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# independent streams drawn from one --seed
STREAMS = {'weights': 0, 'images': 1, 'order': 2, 'cues': 3, 'sample': 4,
           'dropout': 5}


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for each stream of a run."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                 STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def block_images(seed: int, n: int, hw: Tuple[int, int], block: int,
                 colors: int, noise: float, device) -> torch.Tensor:
    """[n, H, W, 3] uint8 on ``device``: each image's blocks take one of
    its ``colors`` random colours, plus noise, clamped and rounded."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, w = hw
    nby, nbx = -(-h // block), -(-w // block)
    lab = torch.randint(0, colors, (n, nby, nbx), generator=g,
                        device=device)
    palette = torch.rand((n, colors, 3), generator=g, device=device) * 255
    up = lab.repeat_interleave(block, 1).repeat_interleave(block, 2)[
        :, :h, :w]
    imgs = torch.gather(palette, 1, up.reshape(n, -1, 1).expand(-1, -1, 3))
    imgs = imgs.view(n, h, w, 3) + noise * torch.randn(
        (n, h, w, 3), generator=g, device=device)
    return imgs.clamp(0, 255).round().to(torch.uint8)


def image_pool(seed: int, t: dict, device) -> List[np.ndarray]:
    """The pool as host arrays, one [n_size, H, W, 3] uint8 array per
    size of ``t['sizes']``."""
    sizes = [tuple(s) for s in t['sizes']]
    per = t['pool'] // len(sizes)
    out = []
    for k, hw in enumerate(sizes):
        out.append(block_images(sub_seed(seed, 'images') + k, per, hw,
                                t['block'], t['colors'], t['noise'],
                                device).cpu().numpy())
    return out


def call_order(seed: int, t: dict, calls: int) -> np.ndarray:
    """[calls, batch, 2] (size index, image index): each block of
    len(sizes) calls visits every size once in a seeded order, and each
    size's images are drawn in a seeded permutation, so every seed sends
    the same sizes equally often."""
    rng = np.random.default_rng(sub_seed(seed, 'order'))
    n_sizes = len(t['sizes'])
    per = t['pool'] // n_sizes
    batch = t['batch']
    sizes = np.concatenate([rng.permutation(n_sizes)
                            for _ in range(-(-calls // n_sizes))])[:calls]
    out = np.empty((calls, batch, 2), np.int64)
    out[:, :, 0] = sizes[:, None]
    streams = {s: iter(()) for s in range(n_sizes)}

    def draw(s):
        while True:
            for i in streams[s]:
                return i
            streams[s] = iter(rng.permutation(per))
    for c in range(calls):
        for j in range(batch):
            out[c, j, 1] = draw(sizes[c])
    return out


def gather(pool: List[np.ndarray], picks: np.ndarray) -> np.ndarray:
    """The host batch of one call: [batch, H, W, 3] uint8 (one size a
    call)."""
    s = int(picks[0, 0])
    return pool[s][picks[:, 1]]


def image_tags(seed: int, t: dict, n: int, n_fg: int) -> np.ndarray:
    """Tags [n, n_fg] float32 of ``n`` images, each with ``tags`` =
    [lo, hi] classes."""
    rng = np.random.default_rng(sub_seed(seed, 'cues'))
    lo, hi = t['tags']
    tags = np.zeros((n, n_fg), np.float32)
    for row in tags:
        row[rng.choice(n_fg, rng.integers(lo, hi + 1), replace=False)] = 1
    return tags


def train_cues(seed: int, t: dict, n: int, n_classes: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Cues [n, g, g, n_classes] float32 and tags [n, n_classes] float32
    of ``n`` training images: each image carries background and
    ``tags`` = [lo, hi] foreground classes; each block of the seed grid
    takes one of them, and a share ``cue_keep`` of the seed pixels keeps
    its one-hot cue (the rest are 0, as thresholded Grad-CAM cues
    leave most of the grid)."""
    rng = np.random.default_rng(sub_seed(seed, 'cues'))
    g = t['seed_grid']
    lo, hi = t['tags']
    cell = max(1, round(g * t['block'] / t['sizes'][0][0]))
    nb = -(-g // cell)
    cues = np.zeros((n, g, g, n_classes), np.float32)
    tags = np.zeros((n, n_classes), np.float32)
    for i in range(n):
        fg = 1 + rng.choice(n_classes - 1, rng.integers(lo, hi + 1),
                            replace=False)
        present = np.concatenate([[0], fg])
        tags[i, present] = 1
        lab = present[rng.integers(0, len(present), (nb, nb))]
        lab = np.repeat(np.repeat(lab, cell, 0), cell, 1)[:g, :g]
        keep = rng.random((g, g)) < t['cue_keep']
        cues[i, keep, lab[keep]] = 1
    return cues, tags
