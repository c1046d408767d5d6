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
            == before['bilateral_color_blur'] + 3)
    with K.plain_versions():
        plain = g.filter(x)
    torch.testing.assert_close(g.filter(x), plain, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('c', [21, 40, 1])
def test_v1_kernels_match_plain_on_card(cuda_device, c):
    """Production colour geometry (gc 16, t 8) on a ragged 60x52 guide,
    batch 2: the tile splat, fold, fused fold+blur and cube blur sum in
    a fixed order and equal their plain versions bit for bit; so does a
    whole filter on either v1 route."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    imgs = torch.rand((2, 60, 52, 3), generator=gen,
                      device=cuda_device) * 255
    g = mxu_grid.MXUBilateralGrid(imgs, 8.0, 13.0, c, cell_mult=1.35)
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
def test_cube_blur_cuts_a_large_cube_on_card(cuda_device):
    """gc 52 (srgb 5): one channel's cube is 562 KB, more than a block's
    shared memory, so the kernel cuts it along cr; still bit-equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    grid = torch.rand((1, 2, 2, 52, 52, 52, 1), generator=gen,
                      device=cuda_device)
    taps = mxu_grid._blur_taps(0.913)[2:]
    assert K.cube_tiling(52, 1) == (1, 8)
    assert torch.equal(K.bilateral_cube_blur(grid, taps),
                       K.bilateral_cube_blur_plain(grid, taps))
    part = torch.rand((1, 1, 1, 4, 52, 52, 52, 1), generator=gen,
                      device=cuda_device)
    assert torch.equal(K.bilateral_fold_blur(part, taps),
                       K.bilateral_fold_blur_plain(part, taps))


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
@pytest.mark.parametrize('c', [21, 1])
def test_aligned_kernels_match_plain_on_card(cuda_device, c):
    """Production colour geometry (sxy 40 -> t 20, gc 16) on a ragged
    70x52 guide, batch 2: the aligned splat within 1e-5 of its max
    (atomics), the aligned slice bit-equal (a gather), the whole filter
    within 1e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    imgs = torch.rand((2, 70, 52, 3), generator=gen,
                      device=cuda_device) * 255
    g = mxu_grid.AlignedBilateralGrid(imgs, 40.0, 13.0, c, cell_mult=1.35)
    assert (g.t, g.nty, g.ntx, g.gc) == (20, 4, 3, 16)
    x = torch.rand((2, 70, 52, c), generator=gen, device=cuda_device)
    before = dict(K.LAUNCHES)
    ref = K.bilateral_splat_aligned_plain(x, g.cell, g.t, g.gc)
    got = K.bilateral_splat_aligned(x, g.cell, g.t, g.gc)
    assert got.shape == ref.shape == (2, 4, 3, 16, 16, 16, c)
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
def test_flat_color_blur_matches_plain_on_card(cuda_device):
    """Both forms of the scatter grid's colour blur on a (3, 2, 24^3)
    grid of 21 channels, with three different tap sets: bit-equal to the
    plain chain, one launch a pass."""
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
    assert K.LAUNCHES['flat_color_blur'] == before['flat_color_blur'] + 3
    split = pallas_blur.blur_color_axes(grid, ks, strides,
                                        (3, 2, gc, gc, gc))
    assert K.LAUNCHES['flat_color_blur'] == before['flat_color_blur'] + 6
    with K.plain_versions():
        assert torch.equal(fused, pallas_blur.color_blur_fused(grid, ks,
                                                               strides))
        assert torch.equal(split, pallas_blur.blur_color_axes(
            grid, ks, strides, (3, 2, gc, gc, gc)))
    inner = (slice(None), slice(None)) + (slice(2, -2),) * 3
    a = fused.view(3, 2, gc, gc, gc, c)[inner]
    b = split.view(3, 2, gc, gc, gc, c)[inner]
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
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
    assert K.LAUNCHES['flat_color_blur'] == before + 6
