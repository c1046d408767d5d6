"""The port's scatter bilateral grid (``BilateralGrid``) and its
colour-axis blur (``pallas_blur``) against the JAX package, on seeded
numpy inputs.

Tolerances.  The reference scatters in bf16 (each add rounds) and
computes in f32 from the first blur pass on.  The f32 port stays within
one bf16 rounding of the scattered sums: 4e-3 (2^-8) of the largest
output (measured 4.7e-4 to 7.5e-4 over the three modes).  With the
reference-rounding switch the scatter rounds where and in the order the
reference's does, and what is left is the f32 order of adds in the
blurs: 1e-6 of the largest output (measured <= 1.8e-7).  The colour blur alone is f32 on both sides: 1e-5 of
the largest value, margin cells included where both sides run the same
form.  The reference's Pallas kernels run in interpret mode here (a
keyword the test adds to ``pl.pallas_call``; nothing in the JAX package
changes)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from wsss_tpu.ops.crf import meanfield as jax_mf
from wsss_tpu.ops.crf import pallas_blur as jax_blur
from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.ops.crf import meanfield as mf
from wsss_tpu_torch.ops.crf import pallas_blur

MODES = ('fast', 'nearest', 'multilinear')


def _guide(seed, h=20, w=24, c=4):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
    return img, x


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('ref_round,tol', [(False, 4e-3), (True, 1e-6)])
def test_filter_matches_jax(mode, ref_round, tol):
    img, x = _guide(0)
    want = np.asarray(jax_mf.BilateralGrid(
        jnp.asarray(img), 5.0, 60.0, mode=mode).filter(jnp.asarray(x)))
    grid = mf.BilateralGrid(torch.from_numpy(img), 5.0, 60.0, mode=mode,
                            ref_round=ref_round)
    assert grid.gshape == jax_mf._grid_shape(img.shape[:2], 5.0, 60.0)
    got = grid.filter(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f'{mode} ref_round={ref_round}: max err {err:.3e} of the max')
    assert err <= tol, err


@pytest.mark.parametrize('mode', MODES)
def test_batched_filter_equals_per_image(mode):
    """Batching changes no math: image b of a batch gets the bits of the
    same image filtered alone."""
    pairs = [_guide(s) for s in (1, 2, 3)]
    imgs = torch.from_numpy(np.stack([p[0] for p in pairs]))
    xs = torch.from_numpy(np.stack([p[1] for p in pairs]))
    batched = mf.BilateralGrid(imgs, 5.0, 60.0, mode=mode).filter(xs)
    for b in range(3):
        one = mf.BilateralGrid(imgs[b], 5.0, 60.0, mode=mode).filter(xs[b])
        assert torch.equal(batched[b], one), (mode, b)


def test_blur_helpers_match_jax():
    rng = np.random.default_rng(4)
    for mode in MODES:
        for s in mf._GRID_BLUR_SIGMA[mode]:
            np.testing.assert_array_equal(
                mf._blur_kernel1d(s, mf._GRID_BLUR_RADIUS),
                jax_mf._blur_kernel1d(s, jax_mf._GRID_BLUR_RADIUS))
    assert mf._GRID_BLUR_SIGMA == jax_mf._GRID_BLUR_SIGMA
    x = rng.normal(0, 1, (5, 6, 40)).astype(np.float32)
    k = mf._blur_kernel1d(0.866, 2)
    for axis in (0, 1):
        np.testing.assert_allclose(
            mf._sep_conv(torch.from_numpy(x), k, axis).numpy(),
            np.asarray(jax_mf._sep_conv(jnp.asarray(x), jnp.asarray(k),
                                        axis)), atol=1e-6)
    np.testing.assert_allclose(
        mf._flat_conv_last(torch.from_numpy(x), k, 8).numpy(),
        np.asarray(jax_mf._flat_conv_last(jnp.asarray(x), jnp.asarray(k),
                                          8)), atol=1e-6)


def _color_case(gc, c, seed=0):
    f = gc ** 3 * c
    grid = np.random.default_rng(seed).random((3, 2, f)).astype(np.float32)
    ks = [mf._blur_kernel1d(s, 2) for s in (0.913, 0.866, 0.816)]
    return grid, ks, (gc * gc * c, gc * c, c), (3, 2, gc, gc, gc)


def _interior(a, gc, c):
    """Cells at least 2 from every colour-axis end: the cells a filter
    splats into and slices from."""
    a = np.asarray(a).reshape(a.shape[:2] + (gc, gc, gc, c))
    return a[:, :, 2:-2, 2:-2, 2:-2]


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(jax_blur.pl, 'pallas_call', functools.partial(
        pl.pallas_call, interpret=True))


@pytest.mark.parametrize('gc,c,form', [(9, 5, 'fused'), (16, 30, 'split')])
def test_blur_color_axes_matches_jax(interpret_pallas, gc, c, form):
    """Both forms of the dispatch against the reference's Pallas kernels
    (every cell, margins included: 1e-5 of the max) and against the
    ``_flat_conv_last`` chain (fused form: every cell; split form: the
    non-margin cells, since a per-gr stripe's ends are zero-filled)."""
    grid, ks, strides, gshape = _color_case(gc, c)
    f = grid.shape[-1]
    assert pallas_blur.fits_vmem(f) == (form == 'fused')
    assert pallas_blur.fits_vmem(f) == jax_blur.fits_vmem(f)
    assert pallas_blur.VMEM_STRIPE_LIMIT == jax_blur.VMEM_STRIPE_LIMIT
    got = pallas_blur.blur_color_axes(torch.from_numpy(grid), ks, strides,
                                      gshape).numpy()
    want = np.asarray(jax_blur.blur_color_axes(
        jnp.asarray(grid), ks, strides, gshape))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    chain = jnp.asarray(grid)
    for k, s in zip(ks, strides):
        chain = jax_mf._flat_conv_last(chain, jnp.asarray(k), s)
    if form == 'fused':
        np.testing.assert_allclose(got, np.asarray(chain),
                                   atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(_interior(got, gc, c),
                                   _interior(chain, gc, c),
                                   atol=1e-5 * scale)
        assert np.abs(got - np.asarray(chain)).max() > 1e-3 * scale


def test_color_blur_fused_is_the_filters_blur():
    """``color_blur_fused`` on a filter's own grid equals the passes
    ``BilateralGrid.filter`` runs (``color_passes``), bit for bit."""
    img, x = _guide(5)
    bg = mf.BilateralGrid(torch.from_numpy(img), 5.0, 60.0)
    g = bg.splat(torch.from_numpy(x)[None])[0]           # [gy, gx, F]
    passes = bg.color_passes(x.shape[-1])
    got = pallas_blur.color_blur_fused(g, [p[0] for p in passes],
                                       [p[1] for p in passes])
    want = K.flat_color_blur_plain(g, passes)
    assert torch.equal(got, want)


def test_blur_color_axes_refuses_oversized_stripes():
    # F = 1 M elements in 2 gr rows: a per-gr stripe is 2 MB, over 384 KB
    grid = torch.zeros((1, 1, 8 * 128 * 1024))
    with pytest.raises(ValueError, match='too large even per-gr'):
        pallas_blur.blur_color_axes(grid, [[1.0]] * 3, (1, 1, 1),
                                    (1, 1, 2, 1, 1))
    with pytest.raises(ValueError, match='too large even per-gr'):
        jax_blur.blur_color_axes(jnp.zeros((1, 1, 8 * 128 * 1024)),
                                 [[1.0]] * 3, (1, 1, 1), (1, 1, 2, 1, 1))
