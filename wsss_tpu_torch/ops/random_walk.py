"""IRNet path-index geometry, affinity extraction and random-walk
propagation of the port (counterpart of ``wsss_tpu/ops/random_walk.py``;
the reference's ``misc.indexing``, train_irn.py:16,26-27,
vgg16_irn.py:239-300, make_sem_seg_labels.py:70):

  * :class:`PathIndex` — static geometry in numpy: the displacement
    vectors within ``radius`` (a half-plane, so each unordered pair
    appears once) and the discrete line of pixels from the origin to each.
  * :func:`to_affinity` / :func:`to_affinity_sliced` — affinity along each
    path = 1 - max(edge on the path) (vgg16_irn.py:249-262), as one gather
    or as a max over statically shifted crops.
  * :func:`propagate_to_edge` — the dense symmetric pixel-pair affinity
    aff^beta, column-normalized into a transition matrix, squared
    exp_times times (a 2^exp_times-step random walk), applied to the CAM.
    The [N, N] products are float32 matmuls (cuBLAS on the card, TF32 off
    by ``resolve_device``), squared in a ping-pong between two buffers so
    that the walk holds 2 N^2 floats at its peak.
  * :func:`propagate_to_edge_sharded` — the same walk with the [N, N]
    matrix cut into blocks over a mesh's first two axes.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


class PathIndex:
    """Static path geometry for a given search radius.

    Attributes:
      search_dst: [P,2] int — displacement vectors (dy,dx), dy>0 half-plane
        plus (0, dx>0), with dy^2+dx^2 < radius^2.
      paths: [P,L,2] int — pixel offsets along the discrete line from the
        origin to each displacement (endpoint-padded to common length L).
      radius_floor: crop margin used by pair extraction (train_irn.py spec).
    """

    def __init__(self, radius: int):
        self.radius = radius
        self.radius_floor = radius - 1
        dirs = [(0, x) for x in range(1, radius)]
        for y in range(1, radius):
            for x in range(-radius + 1, radius):
                if x * x + y * y < radius * radius:
                    dirs.append((y, x))
        self.search_dst = np.asarray(dirs, np.int32)

        paths = []
        for dy, dx in dirs:
            length_sq = dy * dy + dx * dx
            coords = []
            for y in range(min(0, dy), max(0, dy) + 1):
                for x in range(min(0, dx), max(0, dx) + 1):
                    # squared distance from (y,x) to the line (0,0)->(dy,dx)
                    if (dx * y - dy * x) ** 2 / length_sq < 1:
                        coords.append((y, x))
            # far-to-near like the reference (order irrelevant to max)
            coords.sort(key=lambda c: -abs(c[0]) - abs(c[1]))
            paths.append(coords)
        n = max(len(p) for p in paths)
        self.paths = np.asarray(
            [p + [p[-1]] * (n - len(p)) for p in paths], np.int32)

    def _crop(self, hw: Tuple[int, int]):
        """(flat index grid [H, W], crop height, crop width)."""
        h, w = hw
        rf = self.radius_floor
        return (np.arange(h * w, dtype=np.int64).reshape(h, w), h - rf,
                w - 2 * rf)

    def pair_indices(self, hw: Tuple[int, int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(src [M], dst [P,M]) flat indices of valid pixel pairs, the
        reference's cropped region (vgg16_irn.py:264-280): sources live in
        rows [0, H-rf), cols [rf, W-rf)."""
        full, ch, cw = self._crop(hw)
        rf = self.radius_floor
        src = full[:ch, rf:rf + cw].reshape(-1)
        dst = np.stack([full[dy:dy + ch, rf + dx:rf + dx + cw].reshape(-1)
                        for dy, dx in self.search_dst])
        return src, dst

    def offset_membership(self) -> Tuple[np.ndarray, np.ndarray]:
        """(offsets [O,2], mem [O,P] bool): the unique path-pixel offsets
        across all paths, and which paths contain each offset (endpoint
        padding collapses: membership is a set)."""
        uniq = {}
        for p in range(self.paths.shape[0]):
            for dy, dx in map(tuple, self.paths[p]):
                uniq.setdefault((dy, dx), set()).add(p)
        offsets = np.asarray(sorted(uniq), np.int32)
        mem = np.zeros((len(offsets), self.paths.shape[0]), bool)
        for o, key in enumerate(map(tuple, offsets)):
            mem[o, sorted(uniq[key])] = True
        return offsets, mem

    def path_gather_indices(self, hw: Tuple[int, int]) -> np.ndarray:
        """[P, L, M] flat edge-map indices of every path pixel for every
        valid source position (to_affinity's gather table)."""
        full, ch, cw = self._crop(hw)
        rf = self.radius_floor
        out = np.empty(self.paths.shape[:2] + (ch * cw,), np.int64)
        for p in range(self.paths.shape[0]):
            for i in range(self.paths.shape[1]):
                py, px = self.paths[p, i]
                out[p, i] = full[py:py + ch, rf + px:rf + px + cw].reshape(-1)
        return out


def to_affinity(edge_flat: torch.Tensor, gather_idx) -> torch.Tensor:
    """Affinity along each path: 1 - max(edge) (vgg16_irn.py:249-262).

    edge_flat: [B, H*W] edge values in [0,1]; gather_idx: [P,L,M] from
    :meth:`PathIndex.path_gather_indices`.  Returns [B,P,M]."""
    g = torch.as_tensor(gather_idx, device=edge_flat.device)
    return 1.0 - torch.amax(edge_flat[:, g], dim=2)


def to_affinity_sliced(edge2d: torch.Tensor, pidx: PathIndex
                       ) -> torch.Tensor:
    """:func:`to_affinity` as static shifted slices: every path pixel is a
    translation of the source grid, so max-over-path is a chain of
    maxima over shifted crops masked by per-path membership, with an
    elementwise backward (no scatter).  Gradients differ from the gather
    form's only on exact ties between distinct pixels.

    edge2d: [B, H, W] edge values in [0,1].  Returns [B,P,M] equal to
    ``to_affinity(edge2d.reshape(B,-1), pidx.path_gather_indices((H,W)))``.
    """
    b, h, w = edge2d.shape
    rf = pidx.radius_floor
    ch, cw = h - rf, w - 2 * rf
    offsets, mem = pidx.offset_membership()
    ninf = torch.tensor(-float('inf'), dtype=edge2d.dtype,
                        device=edge2d.device)
    vals = []
    for (dy, dx), m in zip(offsets, mem):
        sl = edge2d[:, dy:dy + ch, rf + dx:rf + dx + cw]
        keep = torch.as_tensor(m, device=edge2d.device)[None, :, None]
        vals.append(torch.where(keep, sl.reshape(b, 1, ch * cw), ninf))
    # balanced tree: log-depth maximum chain
    while len(vals) > 1:
        nxt = [torch.maximum(a, c) for a, c in zip(vals[::2], vals[1::2])]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return 1.0 - vals[0]


def _transition_matrix(edge: torch.Tensor, hw, beta: float, radius: int
                       ) -> torch.Tensor:
    """Column-normalized random-walk transition matrix [N,N] from edge
    probabilities (vgg16_irn.py affinity semantics), in edge's dtype on
    its device.  Two [N,N] buffers live while it runs: the one-sided
    scatter and the symmetrized matrix it returns."""
    h, w = hw
    n = h * w
    pidx = PathIndex(radius)
    src, dst = pidx.pair_indices((h, w))
    aff = to_affinity(edge.reshape(1, -1), pidx.path_gather_indices((h, w)))
    aff = torch.pow(torch.clamp(aff[0], 0.0, 1.0), beta)        # [P,M]
    dev = edge.device
    scratch = torch.zeros((n, n), dtype=edge.dtype, device=dev)
    out = torch.empty_like(scratch)
    rows = torch.as_tensor(np.broadcast_to(src[None], dst.shape).reshape(-1),
                           device=dev)
    cols = torch.as_tensor(dst.reshape(-1), device=dev)
    scratch.index_put_((rows, cols), aff.reshape(-1).to(scratch.dtype),
                       accumulate=True)
    # mat + mat.T + eye into its own buffer: an in-place add of a tensor's
    # own transpose would read elements it has already updated
    torch.add(scratch, scratch.T, out=out)
    out.diagonal().add_(1.0)
    out.div_(torch.clamp(out.sum(dim=0, keepdim=True), min=1e-12))
    return out


def propagate_to_edge(cam: torch.Tensor, edge: torch.Tensor,
                      beta: float = 10.0, exp_times: int = 8,
                      radius: int = 5) -> torch.Tensor:
    """Random-walk CAM propagation (misc.indexing.propagate_to_edge spec;
    called at make_sem_seg_labels.py:70,89,108), on cam's device.

    cam:  [K,H,W] class activation maps (downsized grid).
    edge: [H,W] boundary probabilities in [0,1].
    Returns the propagated CAM [K,H,W].

    aff(i,j) = (1 - max edge along path i->j)^beta for pairs within
    `radius`, aff(i,i)=1, symmetric; T = aff / sum_rows(aff) (column
    normalization); T <- T@T exp_times times; out = cam_flat @ T.
    """
    k, h, w = cam.shape
    n = h * w
    # clamp the search radius for degenerate tiny grids (smoke runs);
    # production grids (>= 320/4) never hit this
    radius = max(2, min(radius, (min(h, w) + 1) // 2))
    t = _transition_matrix(edge.to(torch.float32), (h, w), beta, radius)
    # the scatter's buffer was freed on return; the caching allocator
    # hands it back here, so the walk holds two [n, n] matrices at most
    spare = torch.empty_like(t)
    for _ in range(exp_times):
        torch.matmul(t, t, out=spare)       # out never aliases an input
        t, spare = spare, t
    out = torch.matmul(cam.reshape(k, n).to(torch.float32), t)
    return out.reshape(k, h, w)


def _cat(parts: list, dim: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def propagate_to_edge_sharded(cam: torch.Tensor, edge: torch.Tensor, mesh,
                              beta: float = 10.0, exp_times: int = 8,
                              radius: int = 5) -> torch.Tensor:
    """:func:`propagate_to_edge` with the [N,N] transition matrix cut 2-D
    over the mesh's first two axes, rows x columns (the reference lets
    GSPMD shard it, so the full-resolution DeepGlobe walk fits by adding
    cards instead of downsampling x6, make_sem_seg_labels.py:101-104).

    Each squaring computes block (i, j) on device (i, j) as the product
    of row panel i and column panel j, gathered there: a float32
    ``torch.matmul`` (cuBLAS on the card), as the reference's is XLA's
    dot.  Then the CAM's column blocks, the partial products summed over
    i, come back to cam's device.  As in the reference, ``radius`` is
    used as given: only the unsharded walk clamps it on tiny grids."""
    k, h, w = cam.shape
    n = h * w
    ax_r, ax_c = mesh.axis_names[:2]
    d = np.moveaxis(mesh.devices, [mesh.axis_names.index(ax_r),
                                   mesh.axis_names.index(ax_c)], [0, 1])
    devs = d.reshape(d.shape[0], d.shape[1], -1)[:, :, 0]
    nr, nc = devs.shape
    rb = [n * i // nr for i in range(nr + 1)]
    cb = [n * j // nc for j in range(nc + 1)]
    t = _transition_matrix(edge.to(torch.float32), (h, w), beta, radius)
    blocks = [[t[rb[i]:rb[i + 1], cb[j]:cb[j + 1]].to(devs[i, j],
                                                     copy=True)
               for j in range(nc)] for i in range(nr)]
    del t
    for _ in range(exp_times):
        blocks = [[torch.matmul(
            _cat([blocks[i][jj].to(devs[i, j]) for jj in range(nc)], 1),
            _cat([blocks[ii][j].to(devs[i, j]) for ii in range(nr)], 0))
            for j in range(nc)] for i in range(nr)]
    cam_flat = cam.reshape(k, n).to(torch.float32)
    cols = []
    for j in range(nc):
        parts = [torch.matmul(cam_flat[:, rb[i]:rb[i + 1]].to(devs[i, j]),
                              blocks[i][j]).to(cam.device)
                 for i in range(nr)]
        cols.append(functools.reduce(torch.add, parts))
    return torch.cat(cols, 1).reshape(k, h, w)
