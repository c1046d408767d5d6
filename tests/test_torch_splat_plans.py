"""The planner of the v1 route's tile splat, and the cut of the aligned
slice (CPU; no card, no JAX).

``splat_tiles_plan`` cuts a tile's per-corner partials [4, gc^3, C] into
ranges of colour cells for ``bilateral_splat_tiles``.  Every (gc, C, t)
the v1 route admits gets a plan that fits a block's shared memory and
covers every cell once; and a range-by-range emulation of the kernel in
numpy float32, cut as the plan cuts, writes every element of the
partials once and equals the plain version bit for bit.  The aligned
slice's warps copy runs of 32 flat pixels; an emulation of that cut,
with the kernel's division by a multiply, equals the plain gather.
"""
import math

import numpy as np
import pytest
import torch

from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.ops.crf import mxu_grid


# ---------------------------------------------------------------------------
# bilateral_splat_tiles: ranges of colour cells, four corners a block
# ---------------------------------------------------------------------------

def _v1_shapes():
    """Every (gc, C, t) that mxu_grid.applicable admits at t = 8 .. 48
    (the v1 route takes any of them: by the switch, or past 32 classes)."""
    shapes = []
    for gc in range(2, 65):
        srgb = 255.0 / (gc - 1)
        assert mxu_grid.grid_dims(srgb)[0] == gc
        for t in range(8, 49, 8):
            shapes += [(gc, c, t) for c in range(1, 1024 // gc + 1)
                       if mxu_grid.applicable(float(t), srgb, c)]
    return shapes


def test_v1_shapes_are_what_the_route_admits():
    shapes = _v1_shapes()
    assert {t for _, _, t in shapes} == {8, 16, 24, 32, 40, 48}
    assert max(gc for gc, _, _ in shapes) == 64
    assert max(c for _, c, _ in shapes) == 512            # gc 2
    assert (64, 1, 8) in shapes and (16, 64, 48) in shapes
    assert (64, 1, 24) not in shapes                      # VMEM bound
    assert max(gc for gc, _, t in shapes if t == 48) == 23


def test_every_v1_shape_has_a_plan():
    for gc, c, t in _v1_shapes():
        plan = K.splat_tiles_plan(gc, c, t)
        gc3 = gc ** 3
        # static shared memory: the warps' counts
        assert plan.smem_bytes + 4 * 32 <= K.SMEM_BLOCK, (gc, c, t)
        cut = plan.cut()
        assert len(cut) == plan.ranges
        ends = [m0 + n for m0, n in cut]
        assert [m0 for m0, _ in cut] == [0] + ends[:-1], (gc, c, t)
        assert ends[-1] == gc3 and all(n >= 1 for _, n in cut)
        assert all(n == plan.cells for _, n in cut[:-1])
        assert 1 <= plan.cells < 1 << 19
        assert plan.cells <= -(-gc3 // 8)           # >= 8 ranges' worth
        # a range is whole 128-byte lines of its runs where it has room
        line = 32 // math.gcd(c, 32)
        assert plan.cells % line == 0 or plan.cells < line, (gc, c, t)
        assert plan.seg % 4 == 0 and plan.seg >= plan.cells * c + 3
        # pixel values: the whole tile's where they take <= 16 KB, else
        # chunks of the range's pixels
        assert (plan.chunk == 0) == (4 * t * t * c <= 16384)
        assert 0 <= plan.chunk <= t * t
        staged = plan.chunk or t * t
        assert plan.smem_bytes == 16 * plan.seg + 4 * (
            K._round4(2 * t) + 2 * t * t + staged * c)
        assert plan.threads == 256
        assert plan.blocks_per_sm * plan.threads <= 2048
        assert plan.blocks_per_sm * (plan.smem_bytes + 4 * 32 + 1024) \
            <= K._SMEM_SM


def test_splat_tiles_plan_at_the_paths_shapes():
    """The v1 paths' t 8, gc 16 tiles: C 21 and C 40 stage the tile's
    values whole and take four blocks an SM; C 1 still cuts 8 ranges;
    t 48 stages chunks of a range's pixels."""
    plan = K.splat_tiles_plan(16, 21, 8)
    assert (plan.chunk, plan.blocks_per_sm, plan.ranges) == (0, 4, 32)
    assert plan.cells * 21 * 4 % 128 == 0         # runs of whole lines
    assert K.splat_tiles_plan(16, 40, 8).blocks_per_sm == 4
    assert K.splat_tiles_plan(16, 1, 8).ranges == 8
    assert K.splat_tiles_plan(16, 64, 8).chunk == 0
    assert K.splat_tiles_plan(16, 65, 8).chunk == 63      # 4096 // 65
    assert K.splat_tiles_plan(16, 21, 48).chunk == 64


@pytest.mark.parametrize('tiles,per_sm', [(35, 4), (512, 4), (32, 4),
                                          (1, 8), (9, 3)])
def test_splat_tiles_blocks_take_even_shares(monkeypatch, tiles, per_sm):
    """The launch's persistent blocks, each walking units
    [b * U / G, (b + 1) * U / G) as the kernel does, all take the same
    number of units but the last share, no more than the most the card
    (132 SMs) holds at once would take."""
    monkeypatch.setattr(K, '_blocks', lambda units, bps, dev:
                        max(1, min(units, 132 * bps)))
    units = tiles * K.splat_tiles_plan(16, 21, 8).ranges
    g = K._even_blocks(units, per_sm, None)
    shares = [(b + 1) * units // g - b * units // g for b in range(g)]
    assert sum(shares) == units and min(shares) >= 1
    assert max(shares) == -(-units // min(units, 132 * per_sm))
    assert max(shares) - min(shares) <= 1


def test_splat_tiles_plan_names_a_shape_it_cannot_fit():
    with pytest.raises(ValueError, match='t in 1..64'):
        K.splat_tiles_plan(16, 21, 65)
    with pytest.raises(ValueError, match='gc=2, C=20000, t=8'):
        K.splat_tiles_plan(2, 20000, 8)
    with pytest.raises(ValueError):
        K.splat_tiles_plan(0, 1, 8)


def _emulate_splat_tiles(x, cell, t, gc, plan):
    """The kernel's cut in numpy float32: per tile and range, the range's
    pixels in row-major order (`chunk` at a time where the tile is not
    staged whole), each added into its cell of the four corner segments
    as (w_by * w_bx) * x with the weights' table; then each corner's run
    written once."""
    b, h, w, c = x.shape
    nty, ntx = -(-h // t), -(-w // t)
    gc3 = gc ** 3
    wt = K._tile_weights(t, torch.device('cpu')).numpy()  # [2, t]
    out = np.full((b, nty, ntx, 4, gc3, c), np.nan, np.float32)
    written = np.zeros((b, nty, ntx, 4, gc3), np.int64)
    for bi in range(b):
        for ty in range(nty):
            for tx in range(ntx):
                tc = cell[bi, ty * t:(ty + 1) * t, tx * t:(tx + 1) * t]
                tv = x[bi, ty * t:(ty + 1) * t, tx * t:(tx + 1) * t]
                nx = tc.shape[1]
                flat = tc.reshape(-1)
                for m0, n in plan.cut():
                    seg = np.zeros((4, n, c), np.float32)
                    where = np.nonzero((flat >= m0) & (flat < m0 + n))[0]
                    step = plan.chunk or len(where) or 1
                    for k0 in range(0, len(where), step):
                        for fi in where[k0:k0 + step]:
                            iy, ix = divmod(int(fi), nx)
                            w4 = np.array([wt[by, iy] * wt[bx, ix]
                                           for by in (0, 1) for bx in (0, 1)],
                                          np.float32)
                            seg[:, flat[fi] - m0] += w4[:, None] * tv[iy, ix]
                    out[bi, ty, tx, :, m0:m0 + n] = seg
                    written[bi, ty, tx, :, m0:m0 + n] += 1
    assert (written == 1).all()
    return out.reshape(b, nty, ntx, 4, gc, gc, gc, c)


@pytest.mark.parametrize('hw,t,gc,c,flat', [
    ((13, 17), 8, 3, 21, False),       # ragged 2 x 3 tiles
    ((20, 9), 8, 5, 40, False),        # ragged rows
    ((9, 11), 8, 4, 64, False),
    ((17, 19), 16, 3, 1, False),       # t 16, ragged
    ((17, 19), 16, 3, 21, True),       # 256 pixels of one cell: 4 chunks
    ((11, 10), 8, 6, 5, True),         # a flat-colour tile: one cell
    ((9, 16), 8, 64, 1, False),        # gc 64: 75 ranges a slab
])
def test_splat_tiles_emulation_equals_plain(hw, t, gc, c, flat):
    rng = np.random.default_rng(gc * 100 + c)
    b = 2
    x = rng.normal(0, 1, (b,) + hw + (c,)).astype(np.float32)
    cell = rng.integers(0, gc ** 3, (b,) + hw).astype(np.int32)
    if flat:                     # tile (0, 0) of image 0: every pixel alike
        cell[0, :t, :t] = gc ** 3 // 2
        x[0, 0, 0] = -0.0        # +0.0 + -0.0 is +0.0, as in the plain sum
    plan = K.splat_tiles_plan(gc, c, t)
    assert plan.ranges > 1
    got = _emulate_splat_tiles(x, cell, t, gc, plan)
    want = K.bilateral_splat_tiles_plain(torch.from_numpy(x),
                                         torch.from_numpy(cell), t, gc)
    assert torch.equal(torch.from_numpy(got), want)


# ---------------------------------------------------------------------------
# bilateral_slice_aligned: a warp a run of 32 flat pixels
# ---------------------------------------------------------------------------

def _fast_div(e, d):
    """The kernel's e / d: one wide multiply by ceil(2^32 / d)."""
    m = np.uint64(((1 << 32) + d - 1) // d)
    return ((e.astype(np.uint64) * m) >> np.uint64(32)).astype(np.int64)


@pytest.mark.parametrize('c', [1, 2, 3, 5, 21, 64, 511, 512, 4097,
                               K._SLICE_ALIGNED_MAX_C])
def test_slice_aligned_division_is_exact(c):
    """Every element index a run touches, tail included (< 32 C + 32)."""
    e = np.arange(32 * c + 32, dtype=np.int64)
    assert (_fast_div(e, c) == e // c).all()


def _emulate_slice_aligned(grid, cell, t):
    """The kernel's cut: runs of 32 flat pixels; lane i's grid row from its
    pixel's tile and cell; element e of a run from pixel e / C (the fast
    division) and channel e % C."""
    b, nty, ntx = grid.shape[:3]
    gc3, c = grid.shape[3] ** 3, grid.shape[6]
    _, h, w = cell.shape
    flat_grid = grid.reshape(-1)
    p_all = b * h * w
    out = np.full(p_all * c, np.nan, np.float32)
    for p0 in range(0, p_all, 32):
        n = min(32, p_all - p0)
        p = p0 + np.arange(n)
        bi, rem = np.divmod(p, h * w)
        y, xx = np.divmod(rem, w)
        row = ((bi * nty + y // t) * ntx + xx // t) * gc3 \
            + cell.reshape(-1)[p]
        e = np.arange(n * c)
        i = _fast_div(e, c)
        out[p0 * c + e] = flat_grid[row[i] * c + e - i * c]
    return out.reshape(b, h, w, c)


@pytest.mark.parametrize('b,h,w,t,gc,c', [
    (2, 13, 17, 3, 3, 21),     # runs cross rows and images
    (1, 7, 33, 4, 2, 512),     # a width of 32 + 1
    (3, 5, 9, 5, 4, 1),        # a last run of 7 pixels
    (2, 11, 40, 20, 5, 3),
])
def test_slice_aligned_emulation_equals_plain(b, h, w, t, gc, c):
    rng = np.random.default_rng(c)
    nty, ntx = -(-h // t), -(-w // t)
    grid = rng.normal(0, 1, (b, nty, ntx, gc, gc, gc, c)).astype(np.float32)
    cell = rng.integers(0, gc ** 3, (b, h, w)).astype(np.int32)
    got = _emulate_slice_aligned(grid, cell, t)
    want = K.bilateral_slice_aligned_plain(torch.from_numpy(grid),
                                           torch.from_numpy(cell), t)
    assert torch.equal(torch.from_numpy(got), want)
