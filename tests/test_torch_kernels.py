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
def test_kernel_wrappers_check_their_inputs(cuda_device):
    x = torch.ones((1, 8, 8, 2), device=cuda_device)
    cell = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        K.bilateral_splat(x.double(), cell, 8, 2, 2, 3)
    with pytest.raises(ValueError, match='contiguous'):
        K.bilateral_splat(x.transpose(1, 2), cell, 8, 2, 2, 3)
    with pytest.raises(ValueError, match='does not fit'):
        K.bilateral_splat(x, cell, 8, 3, 2, 3)
