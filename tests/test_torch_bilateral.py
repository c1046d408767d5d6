"""The port's bilateral-grid filter (plain versions of the splat, colour
blur and slice kernels) against the JAX package's MXUBilateralGrid.filter
in Pallas interpret mode, in the v1 layout (interpret default) and the
forced v2 layout of the production kernels.

Tolerances: the reference stores its grid in bf16, so the f32 port
agrees within 2e-2 of the output's largest magnitude (as
tests/test_mxu_grid.py holds the reference to its f64 oracle).  With the
reference-rounding switch the port rounds at the same points and agrees
within 1e-5 of the largest magnitude (measured: bit-equal or one f32
ulp).  The kernels themselves are held against their plain versions on
the card in tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsss_tpu.ops.crf import mxu_grid as jax_grid
from wsss_tpu_torch.ops.crf import mxu_grid


def _compare(imgs, x, sxy, srgb, n_ch, cell_mult=1.0, share_c1=False):
    jg = jax_grid.MXUBilateralGrid(jnp.asarray(imgs), sxy, srgb, n_ch,
                                   interpret=True, cell_mult=cell_mult)
    tgs = [mxu_grid.MXUBilateralGrid(torch.from_numpy(imgs), sxy, srgb,
                                     n_ch, cell_mult=cell_mult,
                                     require8=False, ref_round=rr)
           for rr in (False, True)]
    if share_c1:
        jg = jax_grid.MXUBilateralGrid(jnp.asarray(imgs), sxy, srgb, 1,
                                       interpret=True, cell_mult=cell_mult,
                                       share_from=jg)
        tgs = [mxu_grid.MXUBilateralGrid(
            torch.from_numpy(imgs), sxy, srgb, 1, cell_mult=cell_mult,
            require8=False, ref_round=g.ref_round, share_from=g)
            for g in tgs]
    want = np.asarray(jg.filter(jnp.asarray(x)))
    scale = np.abs(want).max() + 1e-6
    f32, rounded = (g.filter(torch.from_numpy(x)).numpy() for g in tgs)
    assert f32.shape == want.shape
    np.testing.assert_allclose(f32 / scale, want / scale, atol=2e-2)
    np.testing.assert_allclose(rounded / scale, want / scale, atol=1e-5)
    return jg


@pytest.mark.parametrize('layout', ['v1', 'v2'])
@pytest.mark.parametrize('hw,t,srgb,c', [
    ((13, 17), 4, 64.0, 3),   # ragged tiles
    ((16, 16), 4, 96.0, 5),   # exact tiles
    ((11, 9), 3, 64.0, 2),    # t*t=9
])
def test_filter_matches_jax(monkeypatch, layout, hw, t, srgb, c):
    monkeypatch.setattr(jax_grid, 'FORCE_V2_INTERPRET', layout == 'v2')
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (2,) + hw + (3,)).astype(np.float32)
    x = rng.uniform(0, 1, (2,) + hw + (c,)).astype(np.float32)
    jg = _compare(imgs, x, float(t), srgb, c)
    assert jg.v2 == (layout == 'v2')


@pytest.mark.parametrize('layout,c', [('v1', 21), ('v2', 21), ('v2', 1)])
def test_filter_production_colour_geometry(monkeypatch, layout, c):
    """srgb 13, cell_mult 1.35 -> gc 16; t 8: the VOC main path's grid, at
    C=21 (messages) and C=1 through share_from (the normalizer)."""
    monkeypatch.setattr(jax_grid, 'FORCE_V2_INTERPRET', layout == 'v2')
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 255, (1, 16, 16, 3)).astype(np.float32)
    x = (rng.uniform(0, 1, (1, 16, 16, 21)).astype(np.float32) if c > 1
         else np.ones((1, 16, 16, 1), np.float32))
    jg = _compare(imgs, x, 8.0, 13.0, 21, cell_mult=1.35, share_c1=c == 1)
    assert (jg.gc, jg.t) == (16, 8)
    tg = mxu_grid.MXUBilateralGrid(torch.from_numpy(imgs), 8.0, 13.0, 21,
                                   cell_mult=1.35)
    assert (tg.gc, tg.t, tg.gy, tg.gx) == (16, 8, 3, 3)


def test_geometry_follows_tpu_routing():
    assert mxu_grid._spatial_cell(40.0) == (40, 1)
    assert mxu_grid._spatial_cell(4.0) is None          # not 8-aligned
    assert mxu_grid._spatial_cell(4.0, require8=False) == (4, 1)
    for args in [(40.0, 13.0), (80.0, 13.0), (40.5, 13.0), (40.0, 5.0),
                 (2.0, 13.0), (28.0, 40.0), (8.0, 13.0, 21, 1.35)]:
        assert (mxu_grid.applicable(*args)
                == jax_grid.applicable(*args, require8=True)), args
    assert mxu_grid.grid_dims(13.0, 1.35) == jax_grid.grid_dims(13.0, 1.35)
    with pytest.raises(ValueError, match='inapplicable'):
        mxu_grid.MXUBilateralGrid(torch.zeros((1, 16, 16, 3)), 4.0, 64.0, 3)
