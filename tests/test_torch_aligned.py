"""The port's ``AlignedBilateralGrid`` against the JAX package's class
(Pallas interpret mode) and against the numpy oracle of the reference's
own test, on seeded numpy inputs.

Tolerances.  The reference keeps its grid in bf16: the splat's input and
output, the spatial product's operands and output and the cube blur's
output are rounded.  With the reference-rounding switch the port rounds
at the same points; what is left is the order of f32 adds inside a sum
that is then rounded to bf16, which can move a value by one bf16 step:
2^-7 of the largest output (measured 0 on all three cases).  The f32 port is held
to the oracle within 2e-2 of the largest output, the reference's own
bound, and to 1e-5 (measured 1.5e-7: the f32 port has no bf16 rounding
at all)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsss_tpu.ops.crf import mxu_grid as jax_grid
from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.ops.crf import mxu_grid


def _ref_filter_aligned(img, x, t, srgb, cell_mult=1.0):
    """Numpy oracle for the aligned grid: nearest splat/slice into the
    containing tile's cell, sigma sqrt(4 - 1/6) spatial cells."""
    h, w, c = x.shape
    nty, ntx = -(-h // t), -(-w // t)
    gc = int(round(255.0 / (srgb * cell_mult))) + 1
    grid = np.zeros((nty, ntx, gc, gc, gc, c), np.float64)
    cell = np.clip(np.round(img / (srgb * cell_mult)).astype(int), 0,
                   gc - 1)
    for y in range(h):
        for xx in range(w):
            cr, cg, cb = cell[y, xx]
            grid[y // t, xx // t, cr, cg, cb] += x[y, xx]

    def conv_axis(g, sigma, radius, axis):
        taps = np.exp(-0.5 * (np.arange(-radius, radius + 1)
                              / sigma) ** 2)
        out = np.zeros_like(g)
        n = g.shape[axis]
        for i, tap in enumerate(taps):
            off = i - radius
            if abs(off) >= n:
                continue
            src = [slice(None)] * g.ndim
            dst = [slice(None)] * g.ndim
            src[axis] = slice(max(0, off), min(n, n + off))
            dst[axis] = slice(max(0, -off), min(n, n - off))
            out[tuple(dst)] += tap * g[tuple(src)]
        return out

    sig_sp = np.sqrt(4.0 - 1.0 / 6.0)
    rad_sp = max(2, int(np.ceil(3.0 * sig_sp)))
    sig_c = np.sqrt(max((1.0 / cell_mult) ** 2 - 1.0 / 6.0, 0.05))
    for axis, sig, rad in ((0, sig_sp, rad_sp), (1, sig_sp, rad_sp),
                           (2, sig_c, 2), (3, sig_c, 2), (4, sig_c, 2)):
        grid = conv_axis(grid, sig, rad, axis)

    out = np.zeros_like(x, np.float64)
    for y in range(h):
        for xx in range(w):
            cr, cg, cb = cell[y, xx]
            out[y, xx] = grid[y // t, xx // t, cr, cg, cb]
    return out


@pytest.mark.parametrize('args', [
    (40.0, 13.0), (80.0, 13.0), (41.0, 13.0), (40.5, 13.0), (4.0, 13.0),
    (40.0, 13.0, 64), (40.0, 5.0, 21), (40.0, 13.0, 21, 1.35)])
def test_aligned_applicable(args):
    assert (mxu_grid.aligned_applicable(*args)
            == jax_grid.aligned_applicable(*args))


def _case(hw, c, seed=1, b=2):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (b,) + hw + (3,)).astype(np.float32)
    x = rng.uniform(0, 1, (b,) + hw + (c,)).astype(np.float32)
    return imgs, x


CASES = [((13, 17), 6.0, 64.0, 3, 1.0),     # t=3, ragged tiles
         ((16, 16), 8.0, 96.0, 5, 1.0),     # t=4, exact tiles
         ((7, 28), 6.0, 64.0, 3, 1.35)]     # ntx 10: the reference pads to 16


@pytest.mark.parametrize('hw,sxy,srgb,c,cell_mult', CASES)
def test_filter_matches_jax(hw, sxy, srgb, c, cell_mult):
    """Against the reference class with the rounding switch: within one
    bf16 step of the largest output.  The (7, 28) case has 10 tile
    columns, which the reference pads to 16 and the port does not: the
    padding makes no difference."""
    imgs, x = _case(hw, c)
    jg = jax_grid.AlignedBilateralGrid(jnp.asarray(imgs), sxy, srgb, c,
                                       interpret=True, cell_mult=cell_mult)
    want = np.asarray(jg.filter(jnp.asarray(x)))
    tg = mxu_grid.AlignedBilateralGrid(torch.from_numpy(imgs), sxy, srgb, c,
                                       cell_mult=cell_mult, ref_round=True)
    assert (tg.t, tg.nty, tg.gc) == (jg.t, jg.nty, jg.gc)
    assert tg.ntx == -(-hw[1] // tg.t) <= jg.ntx
    np.testing.assert_allclose(np.asarray(tg.taps),
                               jg.taps_col[2:], rtol=1e-6)
    got = tg.filter(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f'{hw} ref_round: max err {err:.3e} of the max')
    assert err <= 2 ** -7, err


@pytest.mark.parametrize('hw,sxy,srgb,c,cell_mult', CASES)
def test_filter_matches_numpy_oracle(hw, sxy, srgb, c, cell_mult):
    imgs, x = _case(hw, c)
    g = mxu_grid.AlignedBilateralGrid(torch.from_numpy(imgs), sxy, srgb, c,
                                      cell_mult=cell_mult)
    got = g.filter(torch.from_numpy(x)).numpy()
    for b in range(2):
        want = _ref_filter_aligned(imgs[b], x[b].astype(np.float64),
                                   int(sxy) // 2, srgb, cell_mult)
        scale = np.abs(want).max() + 1e-6
        err = np.abs(got[b] - want).max() / scale
        print(f'{hw} image {b}: max err {err:.3e} of the max')
        np.testing.assert_allclose(got[b] / scale, want / scale, atol=2e-2)
        assert err <= 1e-5


def test_plain_aligned_kernels_match_definition():
    """Splat then slice with no blur returns, for every pixel, the sum of
    the pixels of its tile that share its colour cell."""
    rng = np.random.default_rng(3)
    b, h, w, c, t, gc = 2, 7, 10, 3, 3, 2
    x = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    cell = rng.integers(0, gc ** 3, (b, h, w)).astype(np.int32)
    grid = K.bilateral_splat_aligned(torch.from_numpy(x),
                                     torch.from_numpy(cell), t, gc)
    assert grid.shape == (b, 3, 4, gc, gc, gc, c)
    np.testing.assert_allclose(grid.sum(dim=(1, 2, 3, 4, 5)).numpy(),
                               x.sum(axis=(1, 2)), rtol=1e-5)
    got = K.bilateral_slice_aligned(grid, torch.from_numpy(cell), t).numpy()
    want = np.zeros_like(x)
    for bi in range(b):
        for y in range(h):
            for xx in range(w):
                ys = slice(y // t * t, y // t * t + t)
                xs = slice(xx // t * t, xx // t * t + t)
                same = cell[bi, ys, xs] == cell[bi, y, xx]
                want[bi, y, xx] = x[bi, ys, xs][same].sum(axis=0)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_constructor_and_filter_check_their_inputs():
    imgs = torch.zeros((1, 12, 12, 3))
    with pytest.raises(ValueError, match='inapplicable'):
        mxu_grid.AlignedBilateralGrid(imgs, 7.0, 64.0, 3)
    with pytest.raises(ValueError, match=r'wants \[B,H,W,3\]'):
        mxu_grid.AlignedBilateralGrid(imgs[0], 6.0, 64.0, 3)
    g = mxu_grid.AlignedBilateralGrid(imgs, 6.0, 64.0, 3)
    with pytest.raises(ValueError, match='channels'):
        g.filter(torch.zeros((1, 12, 12, 4)))
    with pytest.raises(ValueError, match='does not match the guide'):
        g.filter(torch.zeros((1, 12, 13, 3)))
    assert g.filter(torch.ones((1, 12, 12, 2))).shape == (1, 12, 12, 2)
