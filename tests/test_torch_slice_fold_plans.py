"""The cut of the slice and the planner of the v1 route's fold (CPU; no
card, no JAX).

``bilateral_slice`` takes runs of L <= 32 flat pixels a warp
(``slice_run``): lane i works out pixel p0 + i's grid row and four weight
products once, and element e of the run's L*C floats takes them from
pixel e / C, each division a multiply.  ``bilateral_fold`` cuts every
node's cube into spans of whole steps (``fold_plan``) and adds a unit's
1, 2 or 4 source cubes in the reference's order.  Numpy float32 replays
of both cuts, with the kernels' index arithmetic, write every element
once and equal the plain versions bit for bit.
"""
import numpy as np
import pytest
import torch

from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.ops.crf import mxu_grid


def _div32(i, d):
    """The slice's i / d (Div32): the high 64 bits of i * ceil(2^64 / d)
    for 32-bit i, in two 32 x 32-bit halves, or i where d is 1."""
    i = np.asarray(i, dtype=np.uint64)
    if d == 1:
        return i.astype(np.int64)
    m = (2 ** 64 - 1) // d + 1
    mh, ml = np.uint64(m >> 32), np.uint64(m & 0xFFFFFFFF)
    q = (i * mh + ((i * ml) >> np.uint64(32))) >> np.uint64(32)
    return q.astype(np.int64)


# ---------------------------------------------------------------------------
# bilateral_slice: a warp a run of L flat pixels, four corners an element
# ---------------------------------------------------------------------------

def _run(c):
    """The pixels of a warp's run where the slice takes runs."""
    return max(1, min(32, 256 // c))


@pytest.mark.parametrize('pixels', [64, 1900, 6240, 32768, 8 * 321 * 321])
def test_slice_cut_by_size(pixels):
    """A thread an element up to as many elements as 132 SMs hold threads
    (132 x 1024); past that runs of one round of 8 elements a lane
    (L*C <= 256, or one pixel), the longest such run."""
    for c in range(1, 1025):
        run = K.slice_run(c, pixels)
        if pixels * c <= 132 * 1024:
            assert run == 0, c
            continue
        assert 1 <= run <= 32, c
        assert run * c <= 256 or run == 1, c
        assert run == 32 or (run + 1) * c > 256, c
    with pytest.raises(ValueError, match='C=8193'):
        K.slice_run(K._SLICE_MAX_C + 1, pixels)


def test_slice_cut_at_the_paths_shapes():
    """SEC prediction's 1900 pixels at C 21, the wide path's 2048 at C 40
    and the one-run input: a thread an element; the main path's 32768 at
    C 21: runs of 12 pixels (252 floats, 8 a lane)."""
    assert K.slice_run(21, 38 * 50) == 0
    assert K.slice_run(40, 2 * 32 * 32) == 0
    assert K.slice_run(1, 64) == 0
    assert K.slice_run(21, 8 * 64 * 64) == 12


@pytest.mark.parametrize('d', [1, 2, 3, 7, 8, 21, 40, 48, 50, 64, 321,
                               K._SLICE_MAX_C])
def test_slice_division_is_exact(d):
    """Div32 is exact for every element index a run touches
    (e < max(256, C)), for the masked lanes' indices of its last round,
    and for any 32-bit index (pixels by W, rows by H, coordinates by t)."""
    rng = np.random.default_rng(d)
    i = np.concatenate([
        np.arange(max(256, d) + 256),
        rng.integers(0, 2 ** 32, 2000),
        np.arange(1, 200) * d - 1, np.arange(1, 200) * d,
        [2 ** 31 - 1, 2 ** 32 - d, 2 ** 32 - 1]]).astype(np.int64)
    assert (_div32(i, d) == i // d).all()


def _coordinates(p, h, w, t):
    """Image, row, column, tile row and column and the offsets in the
    tile of flat pixels p, by the kernel's divisions."""
    bh = _div32(p, w)
    bi = _div32(bh, h)
    xx, y = p - bh * w, bh - bi * h
    ty, tx = _div32(y, t), _div32(xx, t)
    return bi, ty, tx, y - ty * t, xx - tx * t


def _emulate_slice(grid, cell, t, wts, run):
    """The kernel's cut.  run 0: a thread an element e, its pixel e / C,
    channel e % C, coordinates and weights of its own.  Else runs of `run`
    flat pixels; lane i's row of corner (0, 0) and weight products from
    its pixel; lane l's elements e = e0 + k*32 + l (up to 8 a round), each
    from pixel e / C and channel e % C.  Products and sums in the kernel's
    order; every element is written once."""
    b, gy, gx = grid.shape[:3]
    gc3, c = grid.shape[3] ** 3, grid.shape[6]
    _, h, w = cell.shape
    flat, cells = grid.reshape(-1), cell.reshape(-1)
    sx, sy = gc3 * c, gx * gc3 * c
    p_all = b * h * w
    out = np.full(p_all * c, np.nan, np.float32)
    written = np.zeros(p_all * c, np.int64)

    def weights(p):
        bi, ty, tx, iy, ix = _coordinates(p, h, w, t)
        wy0, fy, wx0, fx = wts[0, iy], wts[1, iy], wts[0, ix], wts[1, ix]
        row = ((bi * gy + ty) * gx + tx) * gc3 + cells[p]
        return row, (wy0 * wx0, wy0 * fx, fy * wx0, fy * fx)   # float32

    def store(at, row, w4, ch):
        base = row * c + ch
        acc = w4[0] * flat[base]
        acc = acc + w4[1] * flat[base + sx]
        acc = acc + w4[2] * flat[base + sy]
        acc = acc + w4[3] * flat[base + sy + sx]
        out[at] = acc
        written[at] += 1

    if run == 0:
        e = np.arange(p_all * c)
        p = _div32(e, c)
        store(e, *weights(p), e - p * c)
    lanes = np.arange(32)
    for p0 in range(0, p_all, run) if run else ():
        n = min(run, p_all - p0)
        row, w4 = weights(p0 + np.arange(n))
        total = n * c
        for e0 in range(0, total, 256):
            rows = min(8, -(-(total - e0) // 32))      # the kernel's m
            e = (e0 + np.arange(rows)[:, None] * 32 + lanes).reshape(-1)
            e = e[e < total]
            q = _div32(e, c)
            store(p0 * c + e, row[q], tuple(v[q] for v in w4), e - q * c)
    assert (written == 1).all()
    return out.reshape(b, h, w, c)


@pytest.mark.parametrize('cut', ['elements', 'runs'])
@pytest.mark.parametrize('b,h,w,t,gc,c', [
    (2, 60, 52, 8, 4, 21),     # ragged tiles; runs cross rows and images
    (2, 60, 52, 8, 3, 1),
    (2, 13, 17, 3, 3, 64),     # odd t
    (3, 5, 9, 4, 3, 21),       # 135 pixels: a last run of 3
    (3, 5, 9, 8, 3, 1),        # a last run of 7
    (1, 9, 7, 4, 2, 512),      # runs of one pixel, two rounds each
    (1, 100, 70, 48, 2, 21),   # t 48: the weight table, not a division
    (1, 33, 97, 16, 2, 3),     # widths 33 and 97
])
def test_slice_emulation_equals_plain(cut, b, h, w, t, gc, c):
    rng = np.random.default_rng(h * w + c)
    gy, gx = -(-h // t) + 1, -(-w // t) + 1
    grid = rng.normal(0, 1, (b, gy, gx, gc, gc, gc, c)).astype(np.float32)
    cell = rng.integers(0, gc ** 3, (b, h, w)).astype(np.int32)
    wts = K._tile_weights(t, torch.device('cpu')).numpy()
    got = _emulate_slice(grid, cell, t, wts, 0 if cut == 'elements'
                         else _run(c))
    want = K.bilateral_slice_plain(torch.from_numpy(grid),
                                   torch.from_numpy(cell), t)
    assert torch.equal(torch.from_numpy(got), want)


def test_slice_weight_products_are_the_plain_versions():
    """The products the lanes shuffle are the plain version's corner
    weights, bit for bit, at t 8 .. 48 (a product computed once a pixel
    has the bits of the plain version's per-pixel product)."""
    for t in (8, 16, 24, 40, 48):
        wts = K._tile_weights(t, torch.device('cpu'))
        cell = torch.zeros((1, t, t), dtype=torch.int32)
        corners = K.corner_rows(cell, t, 2, 2, 1)
        i = torch.arange(t)
        for (_, wq), (a, bb) in zip(corners, ((0, 0), (0, 1), (1, 0),
                                              (1, 1))):
            want = wts[a][i][:, None] * wts[bb][i][None, :]
            assert torch.equal(wq, want), t


# ---------------------------------------------------------------------------
# bilateral_fold: units of (node, span), 1, 2 or 4 sources in order
# ---------------------------------------------------------------------------

def _v1_shapes():
    """Every (gc, C, t) that mxu_grid.applicable admits at t = 8 .. 48
    (the v1 route takes any of them: by the switch, or past 32 classes)."""
    shapes = []
    for gc in range(2, 65):
        srgb = 255.0 / (gc - 1)
        for t in range(8, 49, 8):
            shapes += [(gc, c, t) for c in range(1, 1024 // gc + 1)
                       if mxu_grid.applicable(float(t), srgb, c)]
    return shapes


def _check_plan(plan):
    cube = plan.cube
    assert plan.vec == (4 if cube % 4 == 0 else 1)
    assert plan.span % plan.step == 0 and plan.step % 4 == 0
    cut = plan.cut()
    assert len(cut) == plan.spans
    assert [e0 for e0, _ in cut] == [i * plan.span
                                     for i in range(plan.spans)]
    assert sum(n for _, n in cut) == cube and all(n >= 1 for _, n in cut)
    assert plan.units == plan.nodes * plan.spans < 2 ** 31
    assert 2 * cube + plan.step < 2 ** 31


@pytest.mark.parametrize('nodes', [4, 48, 50, 648])
def test_every_v1_shape_has_a_fold_plan(nodes):
    """Every cube the v1 route admits, at the node counts of 1x1 tiles,
    SEC prediction's guide, the wide path's and batch 8."""
    cubes = {(gc, c) for gc, c, _ in _v1_shapes()}
    assert (64, 1) in cubes and (16, 64) in cubes and (17, 33) in cubes
    for gc, c in sorted(cubes):
        _check_plan(K.fold_plan(gc, c, nodes))


def test_fold_plans_at_the_paths_shapes():
    """SEC's 48 nodes of a C 21 cube (42 steps) are cut into 11 spans, so
    that 528 units fill 132 SMs of 4 blocks; an odd cube takes 4-byte
    words."""
    sec = K.fold_plan(16, 21, 48)
    assert (sec.vec, sec.spans, sec.units) == (4, 11, 528)
    wide = K.fold_plan(16, 40, 50)
    assert wide.vec == 4 and wide.units <= 528
    assert K.fold_plan(17, 33, 12).vec == 1


@pytest.mark.parametrize('gc,c,nodes', [(0, 21, 4), (16, 0, 4),
                                        (16, 21, 0), (1291, 1, 4),
                                        (2, 2 ** 28, 4)])
def test_fold_plan_names_what_it_cannot_fit(gc, c, nodes):
    with pytest.raises(ValueError, match=f'gc={gc}, C={c}'):
        K.fold_plan(gc, c, nodes)


def _emulate_fold(part, plan):
    """The kernel's cut: unit u = node * spans + s; the node's tiles
    (rows sy-1 and sy, columns sx-1 and sx, where they exist) in the
    kernel's order; the span's floats summed from +0.0.  Every grid
    element is written once."""
    b, nty, ntx = part.shape[:3]
    gy, gx = nty + 1, ntx + 1
    cube = plan.cube
    src_all = part.reshape(b, nty, ntx, 4, cube)
    grid = np.full((b * gy * gx, cube), np.nan, np.float32)
    written = np.zeros(grid.shape, np.int64)
    for unit in range(plan.units):
        node, s = divmod(unit, plan.spans)
        r, sx = divmod(node, gx)
        bi, sy = divmod(r, gy)
        ty0, tx0 = max(sy - 1, 0), max(sx - 1, 0)
        nr = 2 if 0 < sy < nty else 1
        nc = 2 if 0 < sx < ntx else 1
        e0 = s * plan.span
        e1 = min(cube, e0 + plan.span)
        if plan.vec == 4:                          # whole float4 words
            assert e0 % 4 == 0 and e1 % 4 == 0
        acc = np.zeros(e1 - e0, np.float32)
        for m in range(nr * nc):
            ty = ty0 + (m >> 1 if nc == 2 else m)
            tx = tx0 + (m & 1 if nc == 2 else 0)
            acc = acc + src_all[bi, ty, tx, (sy - ty) * 2 + (sx - tx),
                                e0:e1]
        grid[node, e0:e1] = acc
        written[node, e0:e1] += 1
    assert (written == 1).all()
    return grid.reshape((b, gy, gx) + part.shape[4:])


@pytest.mark.parametrize('b,nty,ntx,gc,c', [
    (1, 5, 7, 16, 21),         # SEC prediction's ragged 5x7 tiles
    (1, 5, 7, 16, 1),
    (2, 1, 1, 6, 5),           # 1x1 tiles: every node an edge node
    (1, 2, 3, 17, 33),         # an odd cube: 4-byte words
    (2, 4, 4, 8, 40),
])
def test_fold_emulation_equals_plain(b, nty, ntx, gc, c):
    rng = np.random.default_rng(gc * c + nty)
    part = rng.normal(0, 1, (b, nty, ntx, 4, gc, gc, gc, c)
                      ).astype(np.float32)
    part[0, 0, 0, 0] = -0.0          # node (0, 0): +0.0 + -0.0 is +0.0
    plan = K.fold_plan(gc, c, b * (nty + 1) * (ntx + 1))
    assert plan.vec == (1 if gc == 17 else 4)
    got = _emulate_fold(part, plan)
    want = K.bilateral_fold_plain(torch.from_numpy(part)).numpy()
    assert (got.view(np.uint32) == want.view(np.uint32)).all()
    assert not np.signbit(got[0, 0, 0]).any()
