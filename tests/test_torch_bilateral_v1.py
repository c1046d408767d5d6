"""The v1 route of the port's bilateral grid (per-tile partials, fold,
fused or separate colour-cube blur) against the JAX package's
MXUBilateralGrid in Pallas interpret mode, and the port's routing
against the reference's.

Tolerances as tests/test_torch_bilateral.py holds the v2 route: the
reference stores partials and grid in bf16, so the f32 port agrees
within 2e-2 of the output's largest magnitude; with the
reference-rounding switch it rounds where the route's reference kernels
do and agrees within 1e-5.  The plain versions of the v1 kernels are
held against the plain versions of the v2 route's in f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsss_tpu.ops.crf import mxu_grid as jax_grid
from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.ops.crf import mxu_grid

# (srgb, cell_mult, n_ch, WSSS_TPU_MXU_V1 set, n_ch of the grid it shares)
ROUTING = [
    (13.0, 1.35, 21, False, None),     # production: v2
    (13.0, 1.35, 1, False, 21),
    (13.0, 1.35, 21, True, None),      # switched to v1: fused
    (13.0, 1.35, 1, True, 21),
    (13.0, 1.35, 32, False, None),
    (13.0, 1.35, 33, False, None),     # wide: v1, unfused
    (13.0, 1.35, 40, False, None),
    (13.0, 1.35, 64, False, None),
    (13.0, 1.35, 1, False, 40),        # C=1 inherits v1 from a wide grid
    (13.0, 1.35, 65, False, None),     # leaves the grid
    (5.0, 1.0, 1, False, None),        # gc 52: v2 bounds fail, unfused
    (13.0, 1.0, 21, False, None),      # gc 21
    (64.0, 1.0, 3, False, None),
]


@pytest.mark.parametrize('srgb,cell_mult,n_ch,v1,shares', ROUTING)
def test_routing_equals_reference(monkeypatch, srgb, cell_mult, n_ch, v1,
                                  shares):
    monkeypatch.setattr(jax_grid, '_V2_DISABLED', v1)
    monkeypatch.setattr(mxu_grid, '_V2_DISABLED', v1)
    ok = jax_grid.applicable(8.0, srgb, n_ch, cell_mult)
    assert mxu_grid.applicable(8.0, srgb, n_ch, cell_mult) == ok
    assert (mxu_grid.v2_eligible(srgb, n_ch, cell_mult)
            == jax_grid.v2_eligible(srgb, n_ch, cell_mult))
    assert (mxu_grid.v2_active(srgb, n_ch, cell_mult)
            == jax_grid.v2_active(srgb, n_ch, cell_mult))
    imgs = np.zeros((1, 8, 8, 3), np.float32)
    if not ok:
        assert n_ch == 65
        with pytest.raises(ValueError, match='inapplicable'):
            mxu_grid.MXUBilateralGrid(torch.from_numpy(imgs), 8.0, srgb,
                                      n_ch, cell_mult=cell_mult)
        return
    jg = tg = None
    for c in ([shares] if shares else []) + [n_ch]:
        jg = jax_grid.MXUBilateralGrid(jnp.asarray(imgs), 8.0, srgb, c,
                                       cell_mult=cell_mult, share_from=jg)
        tg = mxu_grid.MXUBilateralGrid(torch.from_numpy(imgs), 8.0, srgb, c,
                                       cell_mult=cell_mult, share_from=tg)
    assert tg.gc == jg.gc
    assert tg.v2 == jg.v2
    assert tg.fuse_combine_blur == jg.fuse_combine_blur
    assert not jg.color_blur_einsum


def test_routing_table_covers_every_route():
    """The Motivation rows: (v2, fused) per row as the reference has it."""
    def route(srgb, cm, c, shares=None):
        imgs = torch.zeros((1, 8, 8, 3))
        g = (mxu_grid.MXUBilateralGrid(imgs, 8.0, srgb, shares, cell_mult=cm)
             if shares else None)
        g = mxu_grid.MXUBilateralGrid(imgs, 8.0, srgb, c, cell_mult=cm,
                                      share_from=g)
        return g.v2, g.fuse_combine_blur
    assert route(13.0, 1.35, 21) == (True, True)
    assert route(13.0, 1.35, 33) == (False, False)
    assert route(13.0, 1.35, 64) == (False, False)
    assert route(13.0, 1.35, 1, shares=40) == (False, True)
    assert route(5.0, 1.0, 1) == (False, False)


def test_band_matrix_colour_blur_is_unreachable():
    """`applicable` (and the aligned grid's) admit gc^3 * 4C <= 2 500 000,
    the reference's color_blur_einsum needs gc^3 * C > 1 000 000: no
    admitted grid has it, so the port carries no band-matrix colour
    blur and `filter` refuses such a cube."""
    admitted = 0
    for gc in range(2, 65):
        srgb = 255.0 / (gc - 1)
        assert mxu_grid.grid_dims(srgb) == (gc, gc ** 3)
        for c in range(1, 65):
            ok = mxu_grid.applicable(8.0, srgb, c)
            assert ok == jax_grid.applicable(8.0, srgb, c)
            if ok or jax_grid.aligned_applicable(8.0, srgb, c):
                admitted += 1
                assert gc ** 3 * c <= 625_000 < mxu_grid._CUBE_BLUR_MAX
    assert admitted > 500
    g = mxu_grid.MXUBilateralGrid(torch.zeros((1, 8, 8, 3)), 8.0, 64.0, 3)
    g.n_ch = 1_000_000 // g.gc ** 3 + 1
    with pytest.raises(ValueError, match='exceeds 1000000'):
        g.filter(torch.zeros((1, 8, 8, 1)))


def _compare(imgs, x, sxy, srgb, n_ch, fused, share_c1=False):
    """Port (f32 and ref_round) against the reference in interpret mode
    (v1 there by default); `fused` False unfuses both instances."""
    jg = jax_grid.MXUBilateralGrid(jnp.asarray(imgs), sxy, srgb, n_ch,
                                   interpret=True)
    tgs = [mxu_grid.MXUBilateralGrid(torch.from_numpy(imgs), sxy, srgb,
                                     n_ch, require8=False, ref_round=rr)
           for rr in (False, True)]
    if share_c1:
        jg = jax_grid.MXUBilateralGrid(jnp.asarray(imgs), sxy, srgb, 1,
                                       interpret=True, share_from=jg)
        tgs = [mxu_grid.MXUBilateralGrid(
            torch.from_numpy(imgs), sxy, srgb, 1, require8=False,
            ref_round=g.ref_round, share_from=g) for g in tgs]
    assert not jg.v2 and jg.fuse_combine_blur
    for g in [jg] + tgs:
        assert not g.v2 and g.fuse_combine_blur
        g.fuse_combine_blur = fused
    want = np.asarray(jg.filter(jnp.asarray(x)))
    scale = np.abs(want).max() + 1e-6
    f32, rounded = (g.filter(torch.from_numpy(x)).numpy() for g in tgs)
    assert f32.shape == want.shape
    np.testing.assert_allclose(f32 / scale, want / scale, atol=2e-2)
    np.testing.assert_allclose(rounded / scale, want / scale, atol=1e-5)


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'unfused'])
@pytest.mark.parametrize('hw,t,srgb,c,share_c1', [
    ((13, 17), 4, 96.0, 33, False),    # wide: v1 without a switch, gc 4
    ((13, 17), 4, 96.0, 33, True),     # its C=1 normalizer grid
    ((11, 9), 3, 64.0, 2, False),      # narrow, v1 by the switch, gc 5
])
def test_v1_filter_matches_jax(monkeypatch, fused, hw, t, srgb, c, share_c1):
    monkeypatch.setattr(mxu_grid, '_V2_DISABLED', c <= 32)
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 255, (2,) + hw + (3,)).astype(np.float32)
    x = (np.ones((2,) + hw + (1,), np.float32) if share_c1
         else rng.uniform(0, 1, (2,) + hw + (c,)).astype(np.float32))
    _compare(imgs, x, float(t), srgb, c, fused, share_c1)


def _case(seed=0, b=2, h=13, w=17, c=3, t=4, gc=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (b, h, w, c)).astype(np.float32))
    cell = torch.from_numpy(
        rng.integers(0, gc ** 3, (b, h, w)).astype(np.int32))
    return x, cell, t, -(-h // t) + 1, -(-w // t) + 1, gc


@pytest.mark.parametrize('h,w,t', [(13, 17, 4), (16, 16, 8), (5, 3, 8)])
def test_tiles_then_fold_is_the_splat(h, w, t):
    x, cell, t, gy, gx, gc = _case(h=h, w=w, t=t)
    part = K.bilateral_splat_tiles_plain(x, cell, t, gc)
    assert part.shape == (2, gy - 1, gx - 1, 4, gc, gc, gc, 3)
    assert torch.equal(part, K.bilateral_splat_tiles_plain(x, cell, t, gc))
    want = K.bilateral_splat_plain(x, cell, t, gy, gx, gc)
    got = K.bilateral_fold_plain(part)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    # every pixel's 4 corner weights sum to 1: the partials keep the mass
    np.testing.assert_allclose(part.sum(dim=(0, 1, 2, 3, 4, 5, 6)).numpy(),
                               x.sum(dim=(0, 1, 2)).numpy(), rtol=1e-5)
    # a CPU tensor takes the plain version and counts no launch
    before = dict(K.LAUNCHES)
    assert torch.equal(K.bilateral_fold(K.bilateral_splat_tiles(
        x, cell, t, gc)), got)
    assert K.LAUNCHES == before


def test_fold_order_and_edges():
    """Node (sy, sx) = p11 of tile (sy-1, sx-1) + p10 of (sy-1, sx) + p01
    of (sy, sx-1) + p00 of (sy, sx), tiles outside skipped."""
    rng = np.random.default_rng(5)
    part = torch.from_numpy(rng.uniform(0, 1, (1, 2, 3, 4, 2, 2, 2, 1)
                                        ).astype(np.float32))
    got = K.bilateral_fold_plain(part)
    assert got.shape == (1, 3, 4, 2, 2, 2, 1)
    assert torch.equal(got[0, 0, 0], part[0, 0, 0, 0])
    assert torch.equal(got[0, 2, 3], part[0, 1, 2, 3])
    want = ((part[0, 0, 0, 3] + part[0, 0, 1, 2]) + part[0, 1, 0, 1]) \
        + part[0, 1, 1, 0]
    assert torch.equal(got[0, 1, 1], want)


def test_fused_and_cube_blur_plain_are_fold_then_colour_blur():
    x, cell, t, gy, gx, gc = _case(seed=3, gc=5)
    taps = mxu_grid._blur_taps(0.7)[2:]
    part = K.bilateral_splat_tiles_plain(x, cell, t, gc)
    grid = K.bilateral_fold_plain(part)
    want = K.bilateral_color_blur_plain(grid, taps)
    assert torch.equal(K.bilateral_fold_blur_plain(part, taps), want)
    assert torch.equal(K.bilateral_cube_blur_plain(grid, taps), want)
    assert torch.equal(K.bilateral_fold_blur(part, taps), want)
    assert torch.equal(K.bilateral_cube_blur(grid, taps), want)
    # against the definition: a dense 5-tap blur per colour axis
    k1 = np.array(taps[::-1] + taps[1:])
    band = sum(np.diag(np.full(gc - abs(o), k1[o + 2]), k=o)
               for o in range(-2, 3))
    g64 = grid.numpy().astype(np.float64)
    for axis in (3, 4, 5):
        g64 = np.moveaxis(np.tensordot(band, g64, axes=(1, axis)), 0, axis)
    np.testing.assert_allclose(want.numpy(), g64, rtol=1e-5, atol=1e-6)
