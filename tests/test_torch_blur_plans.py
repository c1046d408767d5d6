"""The planners of the two one-launch colour blurs (CPU; no card).

``color_blur_plan`` cuts the MXU-layout grid for ``bilateral_color_blur``
and ``flat_blur_plan`` cuts the scatter grid's stripes for
``flat_color_blur``.  Every shape their paths can give them gets a plan
that fits a block's shared memory and covers every channel and position
once; and a window-by-window emulation of each kernel in plain torch,
cut as the plan cuts, equals the plain version bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from wsss_tpu_torch.data import registry
from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.ops.crf import config
from wsss_tpu_torch.ops.crf import meanfield as mf
from wsss_tpu_torch.ops.crf import mxu_grid


# ---------------------------------------------------------------------------
# bilateral_color_blur: cr-planes through a ring
# ---------------------------------------------------------------------------

def _v2_shapes():
    """Every (gc, C) that mxu_grid.v2_eligible admits."""
    shapes = []
    for gc in range(1, 64):
        srgb = 255.0 / (gc - 1) if gc > 1 else 1e6
        assert mxu_grid.grid_dims(srgb)[0] == gc
        shapes += [(gc, c) for c in range(1, 41)
                   if mxu_grid.v2_eligible(srgb, c)]
    return shapes


def test_v2_shapes_are_what_the_route_admits():
    shapes = _v2_shapes()
    assert max(gc for gc, _ in shapes) == 24
    assert max(c for _, c in shapes) == 32
    assert len(shapes) == 24 * 32


def test_every_v2_shape_has_a_plan():
    grouped = 0
    for gc, c in _v2_shapes():
        plan = K.color_blur_plan(gc, c)
        assert plan.smem_bytes <= K.SMEM_BLOCK, (gc, c)
        assert 1 <= plan.in_flight <= 3
        # channels: consecutive groups, each channel once
        seen = [c0 + j for c0, n in plan.channel_groups() for j in range(n)]
        assert seen == list(range(c)), (gc, c)
        assert len(plan.channel_groups()) == plan.groups
        if plan.groups > 1:
            grouped += 1
            assert all(n >= 8 for _, n in plan.channel_groups()[:-1])
        # layout: the ring, then A, inside the bytes asked for
        plane = gc * gc * plan.nc
        assert plan.slot >= plane + (3 if plan.groups == 1 else 0)
        assert plan.slot % 4 == 0 and plan.buf_a % 4 == 0
        assert plan.buf_a >= plan.ring * plan.slot
        work = (gc + 4) * gc * plan.nc + 3          # A, and room to align it
        assert plan.smem_bytes >= 4 * (plan.buf_a + work)
        assert plan.threads in (64, 128, 256, 512)
        assert plan.threads >= min(512, gc * plan.nc)   # a thread a row
        assert plan.blocks_per_sm * plan.threads <= 2048
    # the route's largest planes do not fit a ring of whole planes
    assert grouped > 0
    assert K.color_blur_plan(24, 32).groups > 1
    assert K.color_blur_plan(16, 21).groups == 1       # the main path


def test_color_blur_plan_names_a_shape_it_cannot_fit():
    with pytest.raises(ValueError, match='gc=25, C=3'):
        K.color_blur_plan(25, 3)
    # any channel count fits in groups of >= 8
    assert K.color_blur_plan(24, 500).groups == 36


def _blur_axis(x, dim, taps):
    """One radius-2 pass with zero fill, the plain version's expression."""
    acc = taps[0] * x
    for d in (1, 2):
        acc = acc + taps[d] * (K._shift_fill(x, d, dim)
                               + K._shift_fill(x, -d, dim))
    return acc


def _emulate_color_blur(grid, taps, plan):
    """The kernel's cut: per channel group and output cr-plane l, the cr
    taps from the 5 ring planes l-2 .. l+2 (zero outside the cube), then
    cg and cb inside the plane; each output plane written once."""
    b, gy, gx, gc = grid.shape[:4]
    c = grid.shape[6]
    cubes = grid.reshape(b * gy * gx, gc, gc, gc, c)
    out = torch.full_like(cubes, float('nan'))
    written = torch.zeros(gc, c, dtype=torch.int64)
    zero = torch.zeros_like(cubes[:, 0, :, :, :plan.nc])
    for c0, n in plan.channel_groups():
        planes = [cubes[:, l, :, :, c0:c0 + n] for l in range(gc)]

        def ring(l):
            return planes[l] if 0 <= l < gc else zero[..., :n]
        for l in range(gc):
            a = taps[0] * ring(l)
            a = a + taps[1] * (ring(l + 1) + ring(l - 1))
            a = a + taps[2] * (ring(l + 2) + ring(l - 2))
            a = _blur_axis(a, 1, taps)          # cg inside the plane
            out[:, l, :, :, c0:c0 + n] = _blur_axis(a, 2, taps)     # cb
            written[l, c0:c0 + n] += 1
    assert bool((written == 1).all())
    return out.view(grid.shape)


@pytest.mark.parametrize('gc,c,nc', [(2, 3, None), (3, 5, None),
                                     (5, 2, None), (5, 7, 3), (3, 8, 8)])
def test_color_blur_emulation_equals_plain(gc, c, nc):
    """gc 2, 3 and 5 are shorter than the 5 taps; nc cuts the channels
    into groups (3 + 3 + 1) as a channel-grouped plan does."""
    rng = np.random.default_rng(gc * 10 + c)
    grid = torch.from_numpy(
        rng.normal(0, 1, (2, 2, 3, gc, gc, gc, c)).astype(np.float32))
    taps = mxu_grid._blur_taps(0.8)[2:]
    plan = K.color_blur_plan(gc, c)
    if nc is not None:
        plan = dataclasses.replace(plan, nc=nc)
    got = _emulate_color_blur(grid, taps, plan)
    assert torch.equal(got, K.bilateral_color_blur_plain(grid, taps))
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(K.bilateral_color_blur(grid, taps), got)


# ---------------------------------------------------------------------------
# flat_color_blur: windows walked along pass 0's stride
# ---------------------------------------------------------------------------

def _label_count(name):
    for ds in ('VOC2012', 'DeepGlobe_balanced', 'DeepGlobe', 'ADP-morph',
               'ADP-func'):
        if ds in name:
            return registry.get(ds).n_seg_classes
    return registry.get('VOC2012').n_seg_classes       # DSRG, IRNet


def _scatter_cases():
    """(id, gshape, C) for every config of ops/crf/config.py that runs the
    scatter grid at its production image size, for the C 1 normalizer
    and the dataset's label count."""
    c = config
    cases = []
    for (ds, mt), cfg in c.HSN_TEST.items():
        hw = (224, 224) if mt == 'M7' or ds.startswith('ADP') else (321, 321)
        cases.append((f'hsn-{ds}-{mt}', cfg, hw))
    for ds, cfg in c.SEC_TEST.items():
        cases += [(f'sec-{ds}-{hw[0]}', cfg, hw)
                  for hw in ((321, 321), (375, 500))]
    cases += [('dsrg-test', c.DSRG_TEST, (321, 321)),
              ('irn-label', c.IRN_LABEL, (321, 321)),
              ('irn-label-300', c.IRN_LABEL, (300, 300))]
    out = []
    for name, cfg, hw in cases:
        if mf.bilateral_structure(hw, cfg.bi_sxy, cfg.bi_srgb) != 'grid':
            continue
        gshape = mf._grid_shape(hw, cfg.bi_sxy, cfg.bi_srgb)
        out += [(f'{name}-c{n}', gshape, n) for n in (1, _label_count(name))]
    return out


def _grid_passes(gshape, c, ks):
    _, _, _, gg, gb = gshape
    return [(ks[0], gg * gb * c), (ks[1], gb * c), (ks[2], c)]


def _check_plan(plan, n_stripes, length, passes):
    assert plan.smem_bytes + 4 * 17 <= K.SMEM_BLOCK
    assert plan.stride == passes[0][1] and plan.taps0 == len(passes[0][0])
    halos = [0] * len(passes)
    for p in range(len(passes) - 2, -1, -1):
        halos[p] = halos[p + 1] + (len(passes[p + 1][0]) - 1) // 2 \
            * passes[p + 1][1]
    assert list(plan.halos) == halos
    # positions: the windows tile the walk once, the steps tile [0, L);
    # the walk is pass 0's stride, or the stripe for a tile
    assert plan.walk in (plan.stride, length)
    assert plan.tile == (plan.stride < 2048 and plan.stride < length)
    assert plan.reach == (plan.taps0 // 2 * plan.stride if plan.tile else 0)
    cut = plan.cut()
    assert cut[0][0] == 0 and all(lc >= 1 for _, lc in cut)
    assert all(a + lc == a2 for (a, lc), (a2, _) in zip(cut, cut[1:]))
    assert cut[-1][0] + cut[-1][1] == plan.walk
    assert len(cut) == plan.windows
    assert (plan.steps - 1) * plan.walk < length <= plan.steps * plan.walk
    # layout: the ring (on the walk pass 0 writes over a slot; a tile has
    # a buffer for it), then pass 1's window, with room for float4 reads 3
    # floats past a buffer's end
    w0 = plan.window + 2 * halos[0]
    assert plan.slot >= w0 + 2 * plan.reach + 3 and plan.slot % 4 == 0
    assert plan.buf_y0 == plan.ring * plan.slot
    if plan.tile and len(passes) >= 2:
        assert plan.buf0 >= plan.buf_y0 + w0 + 3 + 4
    else:
        assert plan.buf0 == plan.buf_y0
    w1 = plan.window + 2 * halos[1] + 3 if len(passes) == 3 else 0
    assert plan.smem_bytes >= 4 * (plan.buf0 + w1 + 3)
    assert plan.blocks_per_sm * plan.threads <= 2048


@pytest.mark.parametrize('name,gshape,c', _scatter_cases(),
                         ids=[x[0] for x in _scatter_cases()])
def test_every_scatter_grid_has_a_plan(name, gshape, c):
    """Both forms: the fused chain on whole stripes, and the split form's
    (gg, gb) chain on per-gr stripes followed by the gr pass."""
    ks = [mf._blur_kernel1d(s, mf._GRID_BLUR_RADIUS)
          for s in mf._GRID_BLUR_SIGMA['fast'][2:]]
    gy, gx, gr = gshape[:3]
    f = int(np.prod(gshape[2:])) * c
    passes = _grid_passes(gshape, c, ks)
    forms = [(gy * gx, f, passes), (gy * gx * gr, f // gr, passes[1:]),
             (gy * gx, f, passes[:1])]
    for n_stripes, length, ps in forms:
        plan = K.flat_blur_plan(n_stripes, length, ps)
        _check_plan(plan, n_stripes, length, ps)
    if name.startswith('irn-label-c21'):
        plan = K.flat_blur_plan(gy * gx, f, passes)
        assert plan.halos == (2394, 42, 0) and plan.stride == 65856


def test_flat_blur_plan_names_a_shape_it_cannot_fit():
    with pytest.raises(ValueError, match='L=100000'):
        K.flat_blur_plan(1, 100000, [([1.0], 50000), ([0.5] * 5, 20000)])
    with pytest.raises(ValueError, match='1-3 passes'):
        K.flat_blur_plan(1, 40, [([1.0], 1)] * 4)


def _emulate_flat_blur(x, passes, plan):
    """The kernel's cut: a block owns (a, lc) and walks steps k along the
    walk W.  On the walk (W = pass 0's stride S) pass 0 sums the same
    window of the input windows of steps k - r0 .. k + r0, each
    x[kW + a - halo0 + i], zero outside the stripe; a tile (W = L) loads
    one window r0*S wider on each side and pass 0's tap j reads it j*S
    further on.  Passes 1, 2 shift inside the window; every pass's window
    is zero outside [0, L); the last writes [a, a + lc) once."""
    n_stripes, length = x.shape
    s0, walk = plan.stride, plan.walk
    r0 = (plan.taps0 - 1) // 2
    pad = plan.steps * walk + 2 * (r0 * s0 + plan.halos[0]) + 8
    xp = torch.nn.functional.pad(x, (pad, pad))              # zero fill
    out = torch.full_like(x, float('nan'))
    written = torch.zeros(length, dtype=torch.int64)
    pos = torch.arange(length + 2 * pad) - pad
    for a, lc in plan.cut():
        for k in range(plan.steps):
            fk = k * walk + a
            n0 = lc + 2 * plan.halos[0]

            def window(step):
                lo = step * walk + a - plan.halos[0] - plan.reach + pad
                return xp[:, lo:lo + n0 + 2 * plan.reach]
            if plan.tile:
                ring = [window(k)[:, j * s0:j * s0 + n0]
                        for j in range(plan.taps0)]
            else:
                ring = [window(k + j - r0) for j in range(plan.taps0)]
            taps = passes[0][0]
            y = float(taps[0]) * ring[0]
            for j in range(1, len(taps)):
                y = y + float(taps[j]) * ring[j]
            for p in range(1, len(passes) + 1):
                e = plan.halos[p - 1]
                f = pos[pad + fk - e: pad + fk - e + y.shape[1]]
                y = torch.where((f >= 0) & (f < length), y, 0.0)
                if p == len(passes):
                    break
                taps, st = passes[p]
                n = lc + 2 * plan.halos[p]
                z = float(taps[0]) * y[:, 0:n]
                for j in range(1, len(taps)):
                    z = z + float(taps[j]) * y[:, j * st:j * st + n]
                y = z
            n_out = max(0, min(lc, length - fk))
            out[:, fk:fk + n_out] = y[:, :n_out]
            written[fk:fk + n_out] += 1
    assert bool((written == 1).all())
    return out


_TAPS = {1: [1.0], 3: [0.25, 0.5, 0.25],
         5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
         17: list(np.linspace(0.01, 0.17, 17))}


@pytest.mark.parametrize('tile', [False, True], ids=['walk', 'tile'])
@pytest.mark.parametrize('shape,chain,window', [
    # a small scatter grid's stripe: gr, gg, gb of 6 cells, C 2
    ((3, 6 ** 3 * 2), [(5, 72), (5, 12), (5, 2)], None),
    # the same cut into ragged windows, 5 of 72 positions a walk
    ((3, 6 ** 3 * 2), [(5, 72), (5, 12), (5, 2)], 16),
    # L not a multiple of the stride nor the window; halos past both ends
    ((2, 301), [(3, 37), (17, 2), (1, 5)], 10),
    ((2, 301), [(17, 11), (5, 3)], 7),
    ((4, 250), [(1, 9)], 4),
    # split form: the (gg, gb) chain on per-gr stripes, then gr alone
    ((18, 6 ** 2 * 2), [(5, 12), (5, 2)], None),
    ((3, 6 ** 3 * 2), [(5, 72)], 20),
])
def test_flat_blur_emulation_equals_plain(shape, chain, window, tile):
    """Both ways of cutting a stripe: walking along pass 0's stride with
    a ring of windows, and tiles that carry pass 0's reach (the planner
    takes tiles for strides under 2048, so the walk is forced here)."""
    rng = np.random.default_rng(sum(shape) + len(chain))
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    passes = [(_TAPS[n], st) for n, st in chain]
    plan = K.flat_blur_plan(shape[0], shape[1], passes)
    assert plan.tile
    s0, length = chain[0][1], shape[1]
    walk = length if tile else s0
    window = min(window or plan.window, walk)
    plan = dataclasses.replace(
        plan, walk=walk, reach=(chain[0][0] // 2) * s0 if tile else 0,
        window=window, windows=-(-walk // window),
        steps=-(-length // walk))
    got = _emulate_flat_blur(x, passes, plan)
    want = K.flat_color_blur_plain(x, passes)
    assert torch.equal(got, want)
    assert torch.equal(K.flat_color_blur(x, passes), want)
