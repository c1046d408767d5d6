"""The port's resizes against jax.image.resize (the reference's
ops/filters.py): F.interpolate with antialias when shrinking matches jax's
downsampling, without it jax's upsampling; nearest-exact is jax's
nearest.  Tolerance 1e-5 absolute on unit-scale data (f32 rounding)."""
import numpy as np
import pytest
import torch

from wsss_tpu.ops import filters as jf
from wsss_tpu_torch.ops import filters as tf

SIZES = [(321, 64), (112, 22), (40, 321), (13, 5)]


def _data(n_in, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (2, n_in, n_in, 3)).astype(np.float32)


@pytest.mark.parametrize('n_in,n_out', SIZES)
def test_resize_bilinear_matches_jax(n_in, n_out):
    x = _data(n_in)
    want = np.asarray(jf.resize_bilinear(x, (n_out, n_out)))
    got = tf.resize_bilinear(torch.from_numpy(x), (n_out, n_out)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('n_in,n_out', SIZES)
def test_resize_nearest_matches_jax(n_in, n_out):
    x = _data(n_in, seed=1)
    want = np.asarray(jf.resize_nearest(x, (n_out, n_out)))
    got = tf.resize_nearest(torch.from_numpy(x), (n_out, n_out)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_resize_bilinear_mixed_axes_and_lead_dims():
    """One axis shrinks while the other grows; extra leading dims."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 3, 13, 40, 2)).astype(np.float32)
    want = np.asarray(jf.resize_bilinear(x, (30, 9)))
    got = tf.resize_bilinear(torch.from_numpy(x), (30, 9)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
