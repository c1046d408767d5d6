"""The planner of the v1 route's two cube blurs (CPU; no card, no JAX).

``cube_blur_plan`` cuts node cubes into (node, cr slab, channel group)
units for ``bilateral_cube_blur`` (the grid in) and
``bilateral_fold_blur`` (the four corner partials in, folded as they
land).  Every (gc, C) the v1 route admits gets a plan that fits a
block's shared memory and covers every plane and channel once; and a
unit-by-unit emulation of each kernel in plain torch float32, cut as the
plan cuts (the fold of a plane's four partials from +0.0 in the order
p11, p10, p01, p00, absent tiles skipped; the cr taps from the slab's
input planes only; cg and cb inside the plane), writes every output
element once and equals the plain version bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.ops.crf import mxu_grid


def _v1_cube_shapes():
    """Every (gc, C) that mxu_grid.applicable admits at some t = 8 .. 48
    (the v1 route takes any of them: by the switch, or past 32 classes)."""
    shapes = set()
    for gc in range(2, 65):
        srgb = 255.0 / (gc - 1)
        assert mxu_grid.grid_dims(srgb)[0] == gc
        for t in range(8, 49, 8):
            shapes |= {(gc, c) for c in range(1, 1024 // gc + 1)
                       if mxu_grid.applicable(float(t), srgb, c)}
    return sorted(shapes)


def test_v1_cube_shapes_are_what_the_route_admits():
    shapes = _v1_cube_shapes()
    assert max(gc for gc, _ in shapes) == 64
    assert {(64, 1), (52, 1), (16, 64), (24, 42), (16, 40)} <= set(shapes)
    assert (64, 3) not in shapes and (24, 43) not in shapes
    assert all(gc ** 3 * c <= 625_000 and gc * c <= 1024
               for gc, c in shapes)


@pytest.mark.parametrize('nodes', [1, 48, 2312])
@pytest.mark.parametrize('corners', [1, 4], ids=['cube', 'fold'])
def test_every_v1_shape_has_a_cube_plan(corners, nodes):
    """Node counts: one node, SEC prediction's 48 (B 1, 6x8) and the
    aligned filter's 2312 (B 8, 17x17)."""
    whole = 0
    for gc, c in _v1_cube_shapes():
        plan = K.cube_blur_plan(gc, c, corners, nodes)
        assert plan.smem_bytes <= K.SMEM_BLOCK, (gc, c)
        assert 1 <= plan.in_flight <= 3
        # channels: consecutive groups, each channel once, as even as
        # their number allows (in multiples of 4 where C is one, so that
        # a group's runs copy in 16-byte words)
        groups = plan.channel_groups()
        seen = [c0 + j for c0, n in groups for j in range(n)]
        assert seen == list(range(c)) and len(groups) == plan.groups
        step = 4 if c % 4 == 0 and 4 <= plan.nc < c else 1
        assert plan.nc % step == 0
        assert max(n for _, n in groups) - min(n for _, n in groups) \
            <= step * plan.groups
        whole += plan.groups == 1
        # planes: slabs of nl output planes, each once
        cut = plan.slab_cut()
        assert len(cut) == plan.slabs and cut[0][0] == 0
        assert all(l0 + n == l2 for (l0, n), (l2, _) in zip(cut, cut[1:]))
        assert cut[-1][0] + cut[-1][1] == gc and all(n >= 1 for _, n in cut)
        # layout: slots, the ring (or landing area and folded ring), A
        # with room to align it, and B for the element-parallel rows
        plane = gc * gc * plan.nc
        assert plan.slot % 4 == 0
        assert plan.slot >= plane + (3 if plan.groups == 1 else 0)
        if corners == 1:
            assert plan.buf_a >= (5 + plan.in_flight) * plan.slot
        else:
            assert plan.buf_ring >= plan.in_flight * 4 * plan.slot
            assert plan.buf_a >= plan.buf_ring + 5 * plane
        assert plan.buf_a % 4 == 0 and plan.buf_b % 4 == 0
        assert plan.buf_b >= plan.buf_a + (gc + 4) * gc * plan.nc + 3
        assert plan.smem_bytes >= 4 * (plan.buf_b
                                       + (0 if plan.reg_rows else plane))
        assert plan.reg_rows == (gc <= 24 and gc * plan.nc >= 256)
        assert plan.groups == 1 or plan.nc <= 8
        # registers: 128 a thread in blocks of 512, else 64 in 128-256
        assert plan.threads == 512 if plan.reg_rows else \
            plan.threads in (128, 256)
        assert plan.blocks_per_sm * plan.threads * (
            128 if plan.reg_rows else 64) <= 65536
    # the main width fits whole planes
    assert K.cube_blur_plan(16, 21, corners, nodes).groups == 1
    assert whole > 0


def test_cube_blur_plan_fills_the_card_with_few_nodes():
    """SEC prediction's 48 nodes are cut into cr slabs; a batch of 8's
    648 are not."""
    assert K.cube_blur_plan(16, 21, 4, 48).slabs > 1
    assert K.cube_blur_plan(16, 1, 4, 48).slabs > 1
    assert K.cube_blur_plan(16, 21, 4, 648).slabs == 1
    assert K.cube_blur_plan(16, 21, 1, 648).slabs == 1


def test_cube_blur_plan_names_a_shape_it_cannot_fit():
    with pytest.raises(ValueError, match='gc=128, C=1, corners=4'):
        K.cube_blur_plan(128, 1, 4, 8)
    with pytest.raises(ValueError, match='corners'):
        K.cube_blur_plan(16, 21, 2, 8)
    # any channel count fits, one channel a group at worst
    assert K.cube_blur_plan(64, 2, 4, 8).groups == 2


def _blur_axis(x, dim, taps):
    """One radius-2 pass with zero fill, the plain version's expression."""
    acc = taps[0] * x
    for d in (1, 2):
        acc = acc + taps[d] * (K._shift_fill(x, d, dim)
                               + K._shift_fill(x, -d, dim))
    return acc


def _fold_planes(part, plane, c0, n):
    """[nodes, gc, gc, n]: cr-plane `plane` of every node's folded cube,
    channels c0 .. c0+n: +0.0, then p11, p10, p01, p00 (tile
    (sy-1+dy, sx-1+dx), corner 3-k) added where the tile is in the
    image."""
    b, nty, ntx = part.shape[:3]
    gc = part.shape[4]
    acc = torch.zeros((b, nty + 1, ntx + 1, gc, gc, n))
    for k in range(4):
        dy, dx = k >> 1, k & 1
        src = part[:, :, :, 3 - k, plane, :, :, c0:c0 + n]
        # node (sy, sx) = tile (ty + 1 - dy, tx + 1 - dx)
        present = torch.zeros((b, nty + 1, ntx + 1), dtype=torch.bool)
        present[:, 1 - dy:1 - dy + nty, 1 - dx:1 - dx + ntx] = True
        placed = torch.zeros_like(acc)
        placed[:, 1 - dy:1 - dy + nty, 1 - dx:1 - dx + ntx] = src
        acc = torch.where(present[..., None, None, None], acc + placed, acc)
    return acc.reshape(-1, gc, gc, n)


def _emulate_cube_blur(x, taps, plan):
    """The kernel's cut, unit by unit (all nodes of a (slab, group) at
    once: no sum crosses nodes): the slab's input planes [lo, hi) are the
    only ones its cr taps read (zero outside the cube), then cg and cb
    inside the plane; each output element written once."""
    fold = plan.corners == 4
    if fold:
        b, nty, ntx = x.shape[:3]
        shape = (b, nty + 1, ntx + 1) + tuple(x.shape[4:])
    else:
        shape = tuple(x.shape)
    gc, c = shape[3], shape[6]
    cubes = None if fold else x.reshape(-1, gc, gc, gc, c)
    nodes = int(np.prod(shape[:3]))
    out = torch.full((nodes, gc, gc, gc, c), float('nan'))
    written = torch.zeros(gc, c, dtype=torch.int64)
    for l0, nl in plan.slab_cut():
        lo, hi = max(0, l0 - 2), min(gc, l0 + nl + 2)
        for c0, n in plan.channel_groups():
            ring = {j: (_fold_planes(x, j, c0, n) if fold
                        else cubes[:, j, :, :, c0:c0 + n])
                    for j in range(lo, hi)}
            zero = torch.zeros((nodes, gc, gc, n))

            def tap(j):
                return ring[j] if 0 <= j < gc else zero
            for l in range(l0, l0 + nl):
                a = taps[0] * tap(l)
                a = a + taps[1] * (tap(l + 1) + tap(l - 1))
                a = a + taps[2] * (tap(l + 2) + tap(l - 2))
                a = _blur_axis(a, 1, taps)              # cg
                out[:, l, :, :, c0:c0 + n] = _blur_axis(a, 2, taps)  # cb
                written[l, c0:c0 + n] += 1
    assert bool((written == 1).all())
    return out.view(shape)


# (id, B, nty, ntx, gc, C, nodes the plan is cut for): SEC prediction's
# v1 guide (5x7 ragged tiles) at C 21 and C 1, the wide path's C 40
# (B 2, 4x4 tiles), chip_smoke.py's gc-52 cube (9x9 nodes), and the ends
# of the route's range, on a few tiles
EMULATION_CASES = [
    ('sec_c21', 1, 5, 7, 16, 21, None),
    ('sec_c1', 1, 5, 7, 16, 1, None),
    ('wide_c40', 2, 4, 4, 16, 40, None),
    ('gc52_c1', 1, 2, 2, 52, 1, 81),
    ('gc64_c1', 1, 2, 2, 64, 1, None),
    ('gc24_c42', 1, 2, 1, 24, 42, None),
]


@pytest.mark.parametrize('corners', [4, 1], ids=['fold', 'cube'])
@pytest.mark.parametrize('case', EMULATION_CASES,
                         ids=[cs[0] for cs in EMULATION_CASES])
def test_cube_blur_emulation_equals_plain(case, corners):
    _, b, nty, ntx, gc, c, nodes = case
    rng = np.random.default_rng(gc * 100 + c)
    part = torch.from_numpy(rng.normal(
        0, 1, (b, nty, ntx, 4, gc, gc, gc, c)).astype(np.float32))
    taps = mxu_grid._blur_taps(0.913)[2:]
    nodes = nodes or b * (nty + 1) * (ntx + 1)
    plan = K.cube_blur_plan(gc, c, corners, nodes)
    if corners == 4:
        want = K.bilateral_fold_blur_plain(part, taps)
        got = _emulate_cube_blur(part, taps, plan)
        assert torch.equal(K.bilateral_fold_blur(part, taps), want)
    else:
        grid = K.bilateral_fold_plain(part)
        want = K.bilateral_cube_blur_plain(grid, taps)
        got = _emulate_cube_blur(grid, taps, plan)
        assert torch.equal(K.bilateral_cube_blur(grid, taps), want)
    assert torch.equal(got, want)


@pytest.mark.parametrize('nc,nl', [(3, 5), (1, 1), (7, 16)])
def test_cube_blur_emulation_equals_plain_however_cut(nc, nl):
    """Cuts the planner does not pick here: ragged channel groups and
    slabs, one plane a slab (every slab's halo clipped by the cube's
    ends or not), one slab."""
    rng = np.random.default_rng(nc * 10 + nl)
    part = torch.from_numpy(rng.normal(
        0, 1, (1, 2, 3, 4, 7, 7, 7, 8)).astype(np.float32))
    taps = mxu_grid._blur_taps(0.8)[2:]
    for corners in (4, 1):
        plan = dataclasses.replace(K.cube_blur_plan(7, 8, corners, 12),
                                   nc=nc, nl=nl, slabs=-(-7 // nl))
        x = part if corners == 4 else K.bilateral_fold_plain(part)
        want = K.bilateral_color_blur_plain(K.bilateral_fold_plain(part),
                                            taps)
        assert torch.equal(_emulate_cube_blur(x, taps, plan), want)
