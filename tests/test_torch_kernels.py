"""The bilateral-grid kernels' plain versions against direct numpy
definitions (CPU), and the CUDA kernels against their plain versions
(on a card only: marked ``cuda``, skipped without one).

This file imports no jax, so it also runs on a card's machine:
    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""
import numpy as np
import pytest
import torch

from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.ops.crf import mxu_grid


def _case(seed=0, b=2, h=13, w=17, c=3, t=4, gc=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    cell = rng.integers(0, gc ** 3, (b, h, w)).astype(np.int32)
    gy, gx = -(-h // t) + 1, -(-w // t) + 1
    return x, cell, t, gy, gx, gc


def _splat_np(x, cell, t, gy, gx, gc):
    b, h, w, c = x.shape
    grid = np.zeros((b, gy, gx, gc ** 3, c), np.float64)
    for bi in range(b):
        for y in range(h):
            for xx in range(w):
                fy, fx = (y % t) / t, (xx % t) / t
                for by, wy in ((0, 1 - fy), (1, fy)):
                    for bx, wx in ((0, 1 - fx), (1, fx)):
                        grid[bi, y // t + by, xx // t + bx,
                             cell[bi, y, xx]] += wy * wx * x[bi, y, xx]
    return grid.reshape(b, gy, gx, gc, gc, gc, c)


def test_plain_splat_matches_definition():
    x, cell, t, gy, gx, gc = _case()
    got = K.bilateral_splat_plain(torch.from_numpy(x),
                                  torch.from_numpy(cell), t, gy, gx, gc)
    want = _splat_np(x, cell, t, gy, gx, gc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # bilinear weights sum to 1 per pixel: mass is conserved per channel
    np.testing.assert_allclose(got.sum(dim=(0, 1, 2, 3, 4, 5)).numpy(),
                               x.sum(axis=(0, 1, 2)), rtol=1e-5)


def test_plain_splat_reference_rounding_folds_partials():
    """ref_round splats per-tile partials (bf16) and folds them: equal
    to the f32 splat within bf16 rounding."""
    x, cell, t, gy, gx, gc = _case(seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(cell), t, gy, gx, gc)
    f32 = K.bilateral_splat_plain(*args)
    rounded = K.bilateral_splat_plain(*args, ref_round=True)
    np.testing.assert_allclose(rounded.numpy(), f32.numpy(),
                               atol=2 ** -7 * float(f32.abs().max()))


def test_plain_color_blur_matches_definition():
    rng = np.random.default_rng(2)
    g = rng.uniform(0, 1, (1, 2, 2, 5, 5, 5, 3)).astype(np.float32)
    taps = mxu_grid._blur_taps(0.7)[2:]
    k = np.array(taps[::-1] + taps[1:])
    want = g.astype(np.float64)
    for axis in (3, 4, 5):
        out = np.zeros_like(want)
        for i, tap in enumerate(k):
            off = i - 2
            src = [slice(None)] * 7
            dst = [slice(None)] * 7
            src[axis] = slice(max(0, off), min(5, 5 + off))
            dst[axis] = slice(max(0, -off), min(5, 5 - off))
            out[tuple(dst)] += tap * want[tuple(src)]
        want = out
    got = K.bilateral_color_blur_plain(torch.from_numpy(g), taps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_plain_slice_matches_definition():
    x, cell, t, gy, gx, gc = _case(seed=3)
    rng = np.random.default_rng(4)
    grid = rng.uniform(0, 1, (2, gy, gx, gc, gc, gc, 3)).astype(np.float32)
    got = K.bilateral_slice_plain(torch.from_numpy(grid),
                                  torch.from_numpy(cell), t).numpy()
    flat = grid.reshape(2, gy, gx, gc ** 3, 3)
    b, h, w = cell.shape
    want = np.zeros((b, h, w, 3))
    for bi in range(b):
        for y in range(h):
            for xx in range(w):
                fy, fx = (y % t) / t, (xx % t) / t
                for by, wy in ((0, 1 - fy), (1, fy)):
                    for bx, wx in ((0, 1 - fx), (1, fx)):
                        want[bi, y, xx] += wy * wx * flat[
                            bi, y // t + by, xx // t + bx, cell[bi, y, xx]]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_plain_flat_color_blur_matches_definition():
    """One pass is a flat shift-and-add with zero fill at the stripe's
    ends only: a shift bleeds across the rows of the embedded axis."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3, 40)).astype(np.float32)
    taps, stride = [0.1, 0.5, 1.0, 0.4, 0.2], 4
    want = np.zeros((3, 40))
    for f in range(40):
        for j, tap in enumerate(taps):
            g = f + (j - 2) * stride
            if 0 <= g < 40:
                want[:, f] += tap * x[:, g]
    got = K.flat_color_blur(torch.from_numpy(x), [(taps, stride)])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    two = K.flat_color_blur_plain(torch.from_numpy(x),
                                  [(taps, stride), (taps[1:4], 1)])
    again = K.flat_color_blur_plain(got, [(taps[1:4], 1)])
    assert torch.equal(two, again)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the bilateral kernels are CUDA C++ '
                    'with no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('c', [21, 1])
def test_kernels_match_plain_on_card(cuda_device, c):
    """Production geometry (64x64 guide, t 8, gc 16), batch 2: splat
    within 1e-5 of its max (atomics sum in a run-dependent order), blur
    and slice bit-equal, the whole filter within 1e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    imgs = torch.rand((2, 64, 64, 3), generator=gen,
                      device=cuda_device) * 255
    g = mxu_grid.MXUBilateralGrid(imgs, 8.0, 13.0, c, cell_mult=1.35)
    x = torch.rand((2, 64, 64, c), generator=gen, device=cuda_device)
    args = (g.cell, g.t, g.gy, g.gx, g.gc)
    before = dict(K.LAUNCHES)
    ref = K.bilateral_splat_plain(x, *args)
    got = K.bilateral_splat(x, *args)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(K.bilateral_color_blur(ref, g.taps),
                       K.bilateral_color_blur_plain(ref, g.taps))
    assert torch.equal(K.bilateral_slice(ref, g.cell, g.t),
                       K.bilateral_slice_plain(ref, g.cell, g.t))
    assert K.LAUNCHES['bilateral_splat'] == before['bilateral_splat'] + 1
    assert (K.LAUNCHES['bilateral_color_blur']
            == before['bilateral_color_blur'] + 1)       # one a call
    with K.plain_versions():
        plain = g.filter(x)
    torch.testing.assert_close(g.filter(x), plain, rtol=1e-5, atol=1e-5)


# (C, sxy -> t, srgb, cell_mult): the production colour geometry (gc 16)
# at t 8, 16 and 48 and at C 1 to 64, and the finest cube (gc 64)
V1_CARD_CASES = [(21, 8.0, 13.0, 1.35), (40, 8.0, 13.0, 1.35),
                 (1, 8.0, 13.0, 1.35), (21, 16.0, 13.0, 1.35),
                 (21, 48.0, 13.0, 1.35), (64, 8.0, 13.0, 1.35),
                 (1, 8.0, 255.0 / 63, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize('c,sxy,srgb,mult', V1_CARD_CASES)
def test_v1_kernels_match_plain_on_card(cuda_device, c, sxy, srgb, mult):
    """A ragged 60x52 guide, batch 2: the tile splat, fold, fused
    fold+blur and cube blur sum in a fixed order and equal their plain
    versions bit for bit, the tile splat the same bits on two runs; so
    does a whole filter on either v1 route."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    imgs = torch.rand((2, 60, 52, 3), generator=gen,
                      device=cuda_device) * 255
    g = mxu_grid.MXUBilateralGrid(imgs, sxy, srgb, c, cell_mult=mult)
    assert g.t == int(sxy) and g.gc == (64 if mult == 1.0 else 16)
    x = torch.rand((2, 60, 52, c), generator=gen, device=cuda_device)
    before = dict(K.LAUNCHES)
    part = K.bilateral_splat_tiles(x, g.cell, g.t, g.gc)
    assert torch.equal(part, K.bilateral_splat_tiles(x, g.cell, g.t, g.gc))
    assert torch.equal(part, K.bilateral_splat_tiles_plain(x, g.cell, g.t,
                                                           g.gc))
    grid = K.bilateral_fold(part)
    assert torch.equal(grid, K.bilateral_fold_plain(part))
    assert torch.equal(K.bilateral_fold_blur(part, g.taps),
                       K.bilateral_fold_blur_plain(part, g.taps))
    assert torch.equal(K.bilateral_cube_blur(grid, g.taps),
                       K.bilateral_cube_blur_plain(grid, g.taps))
    for name, n in (('bilateral_splat_tiles', 2), ('bilateral_fold', 1),
                    ('bilateral_fold_blur', 1), ('bilateral_cube_blur', 1)):
        assert K.LAUNCHES[name] == before[name] + n, name
    g.v2 = False
    for fused in (True, False):
        g.fuse_combine_blur = fused
        with K.plain_versions():
            plain = g.filter(x)
        assert torch.equal(g.filter(x), plain), fused


@pytest.mark.cuda
@pytest.mark.parametrize('c', [21, 1])
def test_splat_tiles_writes_every_element_on_card(cuda_device, c):
    """No memset: a block of NaNs of the partials' size, freed, comes back
    from the caching allocator as the partials, and the kernel leaves no
    NaN in it (SEC prediction's 38x50 guide, 5x7 ragged tiles)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    imgs = torch.rand((1, 38, 50, 3), generator=gen,
                      device=cuda_device) * 255
    g = mxu_grid.MXUBilateralGrid(imgs, 8.0, 13.0, c, cell_mult=1.35)
    x = torch.rand((1, 38, 50, c), generator=gen, device=cuda_device)
    shape = (1, 5, 7, 4, g.gc, g.gc, g.gc, c)
    poison = torch.full(shape, float('nan'), device=cuda_device)
    ptr = poison.data_ptr()
    del poison
    part = K.bilateral_splat_tiles(x, g.cell, g.t, g.gc)
    assert part.data_ptr() == ptr and part.shape == shape
    assert not torch.isnan(part).any()
    assert torch.equal(part, K.bilateral_splat_tiles_plain(x, g.cell, g.t,
                                                           g.gc))


# (B, H, W, t, gc, C): widths 33 and 97, a last run of fewer than 32
# pixels, C 1 / 21 / 64, t 8 / 16 / 48
SLICE_CARD_CASES = [(2, 60, 33, 8, 16, 21), (1, 41, 97, 16, 16, 64),
                    (3, 5, 9, 8, 16, 1), (1, 100, 97, 48, 16, 21),
                    (2, 13, 33, 8, 4, 1), (1, 70, 52, 48, 8, 64),
                    (2, 64, 64, 8, 16, 21)]


@pytest.mark.cuda
@pytest.mark.parametrize('cut', ['elements', 'runs'])
@pytest.mark.parametrize('b,h,w,t,gc,c', SLICE_CARD_CASES)
def test_slice_matches_plain_on_card(cuda_device, monkeypatch, cut, b, h, w,
                                     t, gc, c):
    """Both cuts of the slice, each forced by its threshold (a thread an
    element; a warp a run of flat pixels across rows and images):
    bit-equal to the plain version, one launch a call, and every output
    element written: the output comes back from the caching allocator as
    a freed block of NaNs and keeps none."""
    monkeypatch.setattr(K, '_SLICE_ELEMENT_MAX',
                        2 ** 31 if cut == 'elements' else 0)
    assert (K.slice_run(c, b * h * w) == 0) == (cut == 'elements')
    gen = torch.Generator(device=cuda_device).manual_seed(h * w + c)
    gy, gx = -(-h // t) + 1, -(-w // t) + 1
    grid = torch.randn((b, gy, gx, gc, gc, gc, c), generator=gen,
                       device=cuda_device)
    cell = torch.randint(0, gc ** 3, (b, h, w), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    want = K.bilateral_slice_plain(grid, cell, t)
    K._tile_weights(t, cuda_device)                 # cached before the poison
    poison = torch.full((b, h, w, c), float('nan'), device=cuda_device)
    ptr = poison.data_ptr()
    del poison
    before = K.LAUNCHES['bilateral_slice']
    got = K.bilateral_slice(grid, cell, t)
    assert K.LAUNCHES['bilateral_slice'] == before + 1
    assert got.data_ptr() == ptr and got.shape == want.shape
    assert not torch.isnan(got).any()
    assert torch.equal(got, want)


# partials [B, nty, ntx, 4, gc, gc, gc, C]: an odd cube (4-byte words),
# 1x1 tiles (every node an edge node), C 1, SEC prediction's 5x7 tiles
FOLD_CARD_CASES = [(1, 2, 3, 17, 33), (2, 1, 1, 16, 21), (1, 5, 7, 16, 1),
                   (1, 5, 7, 16, 21), (2, 4, 4, 16, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize('b,nty,ntx,gc,c', FOLD_CARD_CASES)
def test_fold_matches_plain_on_card(cuda_device, b, nty, ntx, gc, c):
    """The fold's (node, span) units on seeded partials: bit-equal to the
    plain version, one launch a call, every grid element written (the
    grid comes back from the caching allocator NaN-poisoned)."""
    gen = torch.Generator(device=cuda_device).manual_seed(gc * c + nty)
    part = torch.randn((b, nty, ntx, 4, gc, gc, gc, c), generator=gen,
                       device=cuda_device)
    want = K.bilateral_fold_plain(part)
    shape = (b, nty + 1, ntx + 1, gc, gc, gc, c)
    poison = torch.full(shape, float('nan'), device=cuda_device)
    ptr = poison.data_ptr()
    del poison
    before = K.LAUNCHES['bilateral_fold']
    got = K.bilateral_fold(part)
    assert K.LAUNCHES['bilateral_fold'] == before + 1
    assert got.data_ptr() == ptr and got.shape == want.shape
    assert not torch.isnan(got).any()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_slice_raises_past_its_widest_c_on_card(cuda_device):
    c = K._SLICE_MAX_C + 1
    grid = torch.zeros((1, 2, 2, 1, 1, 1, c), device=cuda_device)
    cell = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match='C <= 8192'):
        K.bilateral_slice(grid, cell, 8)
    grid = torch.ones((1, 2, 2, 1, 1, 1, c - 1), device=cuda_device)
    assert torch.equal(K.bilateral_slice(grid, cell, 8),
                       torch.ones((1, 8, 8, c - 1), device=cuda_device))


@pytest.mark.cuda
def test_cube_blur_cuts_a_large_cube_on_card(cuda_device):
    """gc 52 (srgb 5): a cg row is past the register row phase's 24
    cells, so the plan blurs cg and cb element by element, and its 4
    nodes are cut into cr slabs; still bit-equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    grid = torch.rand((1, 2, 2, 52, 52, 52, 1), generator=gen,
                      device=cuda_device)
    taps = mxu_grid._blur_taps(0.913)[2:]
    plan = K.cube_blur_plan(52, 1, 1, 4)
    assert not plan.reg_rows and plan.slabs > 1, plan
    assert torch.equal(K.bilateral_cube_blur(grid, taps),
                       K.bilateral_cube_blur_plain(grid, taps))
    part = torch.rand((1, 1, 1, 4, 52, 52, 52, 1), generator=gen,
                      device=cuda_device)
    assert torch.equal(K.bilateral_fold_blur(part, taps),
                       K.bilateral_fold_blur_plain(part, taps))


# (gc, C): the ends of the v1 route's range: the finest cube, the widest
# channel count at gc 16, and the largest plane (gc 24, C 42: 97 KB)
CUBE_EDGE_CASES = [(64, 1), (16, 64), (24, 42)]


@pytest.mark.cuda
@pytest.mark.parametrize('gc,c', CUBE_EDGE_CASES)
def test_cube_blurs_at_the_v1_range_ends_on_card(cuda_device, gc, c):
    """Both cube blurs bit-equal to their plain versions on 2 x 2x3 tiles
    at the ends of the v1 route's (gc, C) range, one launch each, and
    every output element written: the output comes back from the caching
    allocator as a freed block of NaNs and keeps none."""
    gen = torch.Generator(device=cuda_device).manual_seed(gc + c)
    taps = mxu_grid._blur_taps(0.913)[2:]
    part = torch.rand((2, 2, 3, 4, gc, gc, gc, c), generator=gen,
                      device=cuda_device)
    shape = (2, 3, 4, gc, gc, gc, c)
    for name, fn, plain, arg in (
            ('bilateral_fold_blur', K.bilateral_fold_blur,
             K.bilateral_fold_blur_plain, part),
            ('bilateral_cube_blur', K.bilateral_cube_blur,
             K.bilateral_cube_blur_plain, K.bilateral_fold_plain(part))):
        want = plain(arg, taps)
        poison = torch.full(shape, float('nan'), device=cuda_device)
        ptr = poison.data_ptr()
        del poison
        before = K.LAUNCHES[name]
        got = fn(arg, taps)
        assert K.LAUNCHES[name] == before + 1
        assert got.data_ptr() == ptr and got.shape == want.shape, name
        assert not torch.isnan(got).any(), name
        assert torch.equal(got, want), name


@pytest.mark.cuda
@pytest.mark.parametrize('t', [24, 40, 48])
def test_splat_is_bit_equal_without_collisions_on_card(cuda_device, t):
    """t 24, 40 and 48 are no powers of two, so a weight i/t divided in a
    kernel would differ from the plain version's (PyTorch multiplies by
    1/t on the card).  With no two pixels of a node's 2t x 2t
    neighbourhood in one colour cell, no two atomic adds meet and the
    splat equals its plain version bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    h, w, gc, c = 2 * t + 5, 3 * t - 7, 22, 3
    assert gc ** 3 >= 4 * t * t
    ys = torch.arange(h, device=cuda_device) % (2 * t)
    xs = torch.arange(w, device=cuda_device) % (2 * t)
    cell = (ys[:, None] * 2 * t + xs[None, :]).to(torch.int32)
    cell = cell[None].expand(2, h, w).contiguous()
    x = torch.rand((2, h, w, c), generator=gen, device=cuda_device)
    gy, gx = -(-h // t) + 1, -(-w // t) + 1
    got = K.bilateral_splat(x, cell, t, gy, gx, gc)
    assert torch.equal(got, K.bilateral_splat_plain(x, cell, t, gy, gx, gc))


@pytest.mark.cuda
def test_color_blur_channel_groups_on_card(cuda_device):
    """The v2 route's largest plane (gc 24, C 32: 74 KB) does not fit a
    ring of whole planes: the plan cuts the channels into groups of
    11, 11 and 10, copied as runs; still one launch and bit-equal.  C 30
    gives runs that are not 16-byte aligned."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    taps = mxu_grid._blur_taps(0.913)[2:]
    for c in (32, 30):
        plan = K.color_blur_plan(24, c)
        assert plan.groups > 1, plan
        grid = torch.rand((1, 2, 3, 24, 24, 24, c), generator=gen,
                          device=cuda_device)
        before = K.LAUNCHES['bilateral_color_blur']
        got = K.bilateral_color_blur(grid, taps)
        assert K.LAUNCHES['bilateral_color_blur'] == before + 1
        assert torch.equal(got, K.bilateral_color_blur_plain(grid, taps)), c


@pytest.mark.cuda
def test_kernel_wrappers_check_their_inputs(cuda_device):
    x = torch.ones((1, 8, 8, 2), device=cuda_device)
    cell = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        K.bilateral_splat(x.double(), cell, 8, 2, 2, 3)
    with pytest.raises(ValueError, match='contiguous'):
        K.bilateral_splat(x.transpose(1, 2), cell, 8, 2, 2, 3)
    with pytest.raises(ValueError, match='does not fit'):
        K.bilateral_splat(x, cell, 8, 3, 2, 3)
    with pytest.raises(TypeError):
        K.bilateral_splat_tiles(x, cell.long(), 8, 3)
    with pytest.raises(ValueError, match='want 8 dims'):
        K.bilateral_fold(torch.ones((1, 1, 1, 4, 27, 2), device=cuda_device))
    with pytest.raises(ValueError, match='partials'):
        K.bilateral_fold_blur(
            torch.ones((1, 1, 1, 3, 3, 3, 3, 2), device=cuda_device),
            (1.0, 0.5, 0.1))
    with pytest.raises(ValueError, match='colour axes'):
        K.bilateral_cube_blur(
            torch.ones((1, 2, 2, 3, 3, 4, 2), device=cuda_device),
            (1.0, 0.5, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize('c,w', [(21, 52), (1, 52), (64, 52), (21, 33)])
def test_aligned_kernels_match_plain_on_card(cuda_device, c, w):
    """Production colour geometry (sxy 40 -> t 20, gc 16) on a ragged
    70 x w guide (w no multiple of 32), batch 2: the aligned splat within
    1e-5 of its max (atomics), the aligned slice bit-equal (a gather),
    the whole filter within 1e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    imgs = torch.rand((2, 70, w, 3), generator=gen,
                      device=cuda_device) * 255
    g = mxu_grid.AlignedBilateralGrid(imgs, 40.0, 13.0, c, cell_mult=1.35)
    ntx = -(-w // 20)
    assert (g.t, g.nty, g.ntx, g.gc) == (20, 4, ntx, 16)
    x = torch.rand((2, 70, w, c), generator=gen, device=cuda_device)
    before = dict(K.LAUNCHES)
    ref = K.bilateral_splat_aligned_plain(x, g.cell, g.t, g.gc)
    got = K.bilateral_splat_aligned(x, g.cell, g.t, g.gc)
    assert got.shape == ref.shape == (2, 4, ntx, 16, 16, 16, c)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(K.bilateral_slice_aligned(ref, g.cell, g.t),
                       K.bilateral_slice_aligned_plain(ref, g.cell, g.t))
    for name in ('bilateral_splat_aligned', 'bilateral_slice_aligned'):
        assert K.LAUNCHES[name] == before[name] + 1, name
    with K.plain_versions():
        plain = g.filter(x)
    torch.testing.assert_close(g.filter(x), plain, rtol=1e-5, atol=1e-5)
    assert (K.LAUNCHES['bilateral_cube_blur']
            == before['bilateral_cube_blur'] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize('b,h,w,t,gc,c', [
    (1, 7, 33, 4, 2, 512),      # the widest C the aligned grid admits
    (3, 5, 9, 5, 4, 1),         # 135 pixels: a last run of 7
    (2, 13, 17, 3, 3, 3),       # runs across rows and images
    (1, 41, 97, 7, 5, 21)])
def test_slice_aligned_edge_shapes_on_card(cuda_device, b, h, w, t, gc, c):
    """The aligned slice's warps copy runs of 32 flat pixels: bit-equal to
    the plain gather at odd t, ragged tiles and runs, C 1 to 512; one
    launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    nty, ntx = -(-h // t), -(-w // t)
    grid = torch.rand((b, nty, ntx, gc, gc, gc, c), generator=gen,
                      device=cuda_device)
    cell = torch.randint(0, gc ** 3, (b, h, w), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    before = K.LAUNCHES['bilateral_slice_aligned']
    got = K.bilateral_slice_aligned(grid, cell, t)
    assert K.LAUNCHES['bilateral_slice_aligned'] == before + 1
    assert torch.equal(got, K.bilateral_slice_aligned_plain(grid, cell, t))


@pytest.mark.cuda
def test_flat_color_blur_matches_plain_on_card(cuda_device):
    """Both forms of the scatter grid's colour blur on a (3, 2, 24^3)
    grid of 21 channels, with three different tap sets: bit-equal to the
    plain chain; the 3-pass chain in one launch, the split form in two
    (2 passes on per-gr stripes, then 1).  Then stripes whose windows and
    steps are ragged, both walked and cut into tiles, and wider taps."""
    from wsss_tpu_torch.ops.crf import meanfield as mf
    from wsss_tpu_torch.ops.crf import pallas_blur
    gc, c = 24, 21
    f = gc ** 3 * c
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    grid = torch.rand((3, 2, f), generator=gen, device=cuda_device)
    ks = [mf._blur_kernel1d(s, 2) for s in (0.913, 0.866, 0.816)]
    strides = (gc * gc * c, gc * c, c)
    before = dict(K.LAUNCHES)
    fused = pallas_blur.color_blur_fused(grid, ks, strides)
    assert K.LAUNCHES['flat_color_blur'] == before['flat_color_blur'] + 1
    split = pallas_blur.blur_color_axes(grid, ks, strides,
                                        (3, 2, gc, gc, gc))
    assert K.LAUNCHES['flat_color_blur'] == before['flat_color_blur'] + 3
    with K.plain_versions():
        assert torch.equal(fused, pallas_blur.color_blur_fused(grid, ks,
                                                               strides))
        assert torch.equal(split, pallas_blur.blur_color_axes(
            grid, ks, strides, (3, 2, gc, gc, gc)))
    inner = (slice(None), slice(None)) + (slice(2, -2),) * 3
    a = fused.view(3, 2, gc, gc, gc, c)[inner]
    b = split.view(3, 2, gc, gc, gc, c)[inner]
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    # ragged windows and steps: a stripe no multiple of the stride, cut
    # into tiles (stride 37) or walked along (stride 2100)
    for stride, length in ((37, 1000), (2100, 10000)):
        x = torch.rand((5, length), generator=gen, device=cuda_device)
        chain = [(ks[0], stride), ([0.25, 0.5, 0.25], 2),
                 (list(range(1, 18)), 1)]
        plan = K.flat_blur_plan(5, length, chain[:2])
        assert plan.tile == (stride < 2048)
        assert plan.cut()[-1][1] < plan.window and length % stride
        for passes in (chain[:2], chain, chain[2:], [(ks[1], length)]):
            n = K.LAUNCHES['flat_color_blur']
            got = K.flat_color_blur(x, passes)
            assert K.LAUNCHES['flat_color_blur'] == n + 1
            assert torch.equal(got, K.flat_color_blur_plain(x, passes))
    with pytest.raises(ValueError, match='odd number of taps'):
        K.flat_color_blur(grid.view(6, f), [([1.0, 0.5], 1)])
    with pytest.raises(ValueError, match='want 2 dims'):
        K.flat_color_blur(grid, [([1.0], 1)])


@pytest.mark.cuda
def test_mean_field_stays_on_the_card(cuda_device, monkeypatch):
    """A fine-colour grid config on card tensors runs the scatter grid
    and ``flat_color_blur`` there, whether or not the host's
    permutohedral library is built."""
    from wsss_tpu_torch.ops.crf import config
    from wsss_tpu_torch.ops.crf import meanfield as mf
    cfg = config.CRFConfig(3, 3, 50, 5, 10, 1)
    hw = (160, 150)                 # 6 x 5 x 56^3 = 5.3 M cells
    monkeypatch.setattr(mf._native, 'available', lambda: True)
    assert mf._fine_color_native_ok(hw, cfg)

    def no_host(*a, **k):
        raise AssertionError('card tensors went to the host route')
    monkeypatch.setattr(mf._native, 'mean_field_native', no_host)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    probs = torch.softmax(torch.randn(hw + (3,), generator=gen,
                                      device=cuda_device), -1)
    img = torch.rand(hw + (3,), generator=gen, device=cuda_device) * 255
    before = K.LAUNCHES['flat_color_blur']
    q = mf.mean_field(probs, img, cfg)
    assert q.is_cuda and torch.isfinite(q).all()
    assert K.LAUNCHES['flat_color_blur'] == before + 2     # one a filter
