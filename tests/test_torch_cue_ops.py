"""The port's cue ops, median3 and Grad-CAM against the JAX package on the
same numpy inputs: every case of tests/test_ops_cues.py, plus tied class
counts, the lowest decile's borders, the sparse cue format (owned by
io/artifacts) and Grad-CAM.

Bool and index outputs are held equal; float outputs within 1e-5 of
their largest magnitude (2e-5 absolute where scipy's blur is the
reference's reference, as in tests/test_ops_cues.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from wsss_tpu.ops import cues as jax_cues
from wsss_tpu.ops import filters as jax_filters
from wsss_tpu.ops import gradcam as jax_gc
from wsss_tpu_torch.io import artifacts
from wsss_tpu_torch.ops import cues
from wsss_tpu_torch.ops import filters
from wsss_tpu_torch.ops import gradcam as gc


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _masks(kind):
    """bool [B,H,W,C] candidate masks: random, or with ties in the pixel
    counts (equal-sized masks, and most classes empty, as in real cues)."""
    rng = np.random.default_rng(0)
    if kind == 'random':
        return rng.random((3, 13, 13, 6)) > 0.6
    loc = np.zeros((2, 12, 12, 7), bool)
    loc[0, :4, :4, 1] = True            # classes 1, 3, 4: 16 px each
    loc[0, 2:6, 2:6, 3] = True
    loc[0, 3:7, 1:5, 4] = True
    loc[0, :, :, 6] = rng.random((12, 12)) > 0.5
    loc[1, 5:9, 5:9, 0] = True          # 0 and 5 tie, 2 is larger
    loc[1, 6:10, 4:8, 5] = True
    loc[1, 2:12, 2:12, 2] = True
    return loc


@pytest.mark.parametrize('kind', ['random', 'tied_counts'])
def test_resolve_overlap_equals_jax(kind):
    loc = _masks(kind)
    want = jax_cues.resolve_overlap(jnp.asarray(loc))
    got = cues.resolve_overlap(_t(loc))
    assert got.dtype == torch.bool
    _equal(got, want)
    assert int(got.sum(-1).max()) <= 1


def test_resolve_overlap_smallest_wins():
    loc = np.zeros((1, 8, 8, 2), bool)
    loc[0, :6, :6, 0] = True            # large
    loc[0, 2:4, 2:4, 1] = True          # small, inside the large one
    out = cues.resolve_overlap(_t(loc)).numpy()
    _equal(out, jax_cues.resolve_overlap(jnp.asarray(loc)))
    assert out[0, 3, 3, 1] and not out[0, 3, 3, 0] and out[0, 0, 0, 0]


@pytest.mark.parametrize('per_image_max', [False, True])
def test_threshold_cams_equals_jax(per_image_max):
    """The batch-wide max (VOC) against the per-image max (ADP): on a
    batch whose images peak at different heights they differ."""
    rng = np.random.default_rng(1)
    cams = rng.random((4, 5, 5, 3)).astype(np.float32)
    cams[1] *= 0.3
    want = jax_cues.threshold_cams(jnp.asarray(cams), 0.5,
                                   per_image_max=per_image_max)
    got = cues.threshold_cams(_t(cams), 0.5, per_image_max=per_image_max)
    _equal(got, want)
    other = cues.threshold_cams(_t(cams), 0.5,
                                per_image_max=not per_image_max)
    assert not torch.equal(got, other)


@pytest.mark.parametrize('hw', [(21, 21), (41, 41), (10, 17)])
def test_bg_cues_lowest_decile_equals_jax(hw):
    rng = np.random.default_rng(2)
    bg = rng.random((2,) + hw + (4,)).astype(np.float32)
    want = np.asarray(jax_cues.bg_cues_lowest_decile(jnp.asarray(bg)))
    got = cues.bg_cues_lowest_decile(_t(bg)).numpy()
    _equal(got, want)
    for i in range(2):        # the reference's host oracle, scipy
        g = scipy.ndimage.median_filter(bg[i].sum(-1), 3)
        thr = np.sort(g.ravel())[int(0.1 * hw[0] * hw[1])]
        _equal(got[i], g < thr)


@pytest.mark.parametrize('shape', [(2, 17, 19), (3, 5, 4), (1, 2, 3, 3)])
def test_median3_equals_jax_at_the_borders(shape):
    """The one-sample edge pad repeats the edge ('symmetric'), which is
    torch's 'replicate': equal everywhere, the borders included."""
    rng = np.random.default_rng(4)
    x = rng.random(shape).astype(np.float32)
    got = filters.median3(_t(x)).numpy()
    _equal(got, jax_filters.median3(jnp.asarray(x)))
    flat = x.reshape((-1,) + shape[-2:])
    _equal(got.reshape(flat.shape),
           np.stack([scipy.ndimage.median_filter(f, 3) for f in flat]))


def test_fg_and_fgbg_cues_equal_jax():
    rng = np.random.default_rng(8)
    fg = rng.random((2, 41, 41, 5)).astype(np.float32)
    fg[..., 2] = 0.0                     # an absent class
    bg = rng.random((2, 41, 41, 5)).astype(np.float32)
    _equal(cues.fg_cues(_t(fg), 0.2),
           jax_cues.fg_cues(jnp.asarray(fg), 0.2))
    _equal(cues.fg_cues(_t(fg), 0.2, per_image_max=True),
           jax_cues.fg_cues(jnp.asarray(fg), 0.2, per_image_max=True))
    got = cues.fgbg_cues(_t(fg), _t(bg), 0.6)
    assert got.shape == (2, 41, 41, 6)
    _equal(got, jax_cues.fgbg_cues(jnp.asarray(fg), jnp.asarray(bg), 0.6))


def test_gaussian_blur_equals_jax():
    rng = np.random.default_rng(3)
    x = rng.random((2, 33, 29)).astype(np.float32)
    got = filters.gaussian_blur(_t(x), sigma=2.0).numpy()
    want = np.asarray(jax_filters.gaussian_blur(jnp.asarray(x), sigma=2.0))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(
        got, np.stack([scipy.ndimage.gaussian_filter(f, 2.0) for f in x]),
        atol=2e-5)


@pytest.mark.parametrize('case', ['morph', 'func'])
def test_modify_by_htt_equals_jax(case):
    rng = np.random.default_rng(5)
    b, h, w, c = 2, 16, 16, 5
    g = rng.random((b, h, w, c)).astype(np.float32)
    g[..., 0] = 0
    img = rng.integers(0, 256, (b, 32, 32, 3)).astype(np.float32)
    kw = dict(exception_inds=(3, 4))
    if case == 'func':
        g[..., 1] = 0
        img[:, :10] = 255.0                     # a strong background band
        kw = dict(exception_inds=(2, 3, 4), other_ind=1)
        adipose = rng.random((b, h, w)).astype(np.float32)
    want = np.asarray(jax_cues.modify_by_htt(
        jnp.asarray(g), jnp.asarray(img),
        adipose_cam=jnp.asarray(adipose) if case == 'func' else None, **kw))
    got = cues.modify_by_htt(
        _t(g), _t(img), adipose_cam=_t(adipose) if case == 'func' else None,
        **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_sparse_roundtrip_equals_jax():
    """The pickle's sparse cue format, which io/artifacts.pack_cues and
    unpack_cues own in the port, against the JAX package's
    cues_to_sparse / sparse_to_cues."""
    rng = np.random.default_rng(7)
    loc = rng.random((2, 9, 9, 4)) > 0.8
    onehot = cues.resolve_overlap(_t(loc))
    packed = artifacts.pack_cues(onehot.numpy(), [[0], [1]], [3, 5])
    want = jax_cues.cues_to_sparse(jax_cues.resolve_overlap(
        jnp.asarray(loc)))
    assert len(want) == 2
    for i, w in zip((3, 5), want):
        s = packed['%d_cues' % i]
        assert s.shape[0] == 3 and s.dtype == w.dtype
        _equal(s, w)
    for k, (i, w) in enumerate(zip((3, 5), want)):
        dense = artifacts.unpack_cues(packed, i, (9, 9, 4))
        _equal(dense, jax_cues.sparse_to_cues(w, (4, 9, 9)))
        _equal(dense > 0.5, onehot[k].numpy())
    empty = {'0_cues': np.zeros((3, 0), np.int64)}
    assert float(artifacts.unpack_cues(empty, 0, (9, 9, 4)).sum()) == 0.0


def _head_problem():
    """A GAP head and a max head over a feature map, as functions of
    numpy weights: the two pooling kinds of the reference's classifiers."""
    rng = np.random.default_rng(9)
    return (rng.normal(0, 1, (3, 3, 3, 8)).astype(np.float32),
            rng.normal(0, 1, (8, 5)).astype(np.float32),
            rng.normal(0, 1, (5,)).astype(np.float32))


@pytest.mark.parametrize('pool', ['mean', 'max'])
def test_gradcam_weights_equals_jax(pool):
    conv, dense, bias = _head_problem()

    def jax_feats(x):
        import jax
        return jax.lax.conv_general_dilated(
            x, jnp.asarray(conv), (1, 1), 'SAME',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC')) + 1.0

    def jax_head(f):
        p = jnp.mean(f, axis=(1, 2)) if pool == 'mean' else \
            jnp.max(f, axis=(1, 2))
        return p @ jnp.asarray(dense) + jnp.asarray(bias)

    def feats(x):
        w = _t(conv).permute(3, 2, 0, 1)
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
        return y.permute(0, 2, 3, 1) + 1.0

    def head(f):
        p = f.mean(dim=(1, 2)) if pool == 'mean' else f.amax(dim=(1, 2))
        return p @ _t(dense) + _t(bias)

    want = np.asarray(jax_gc.gradcam_weights(jax_feats, jax_head, (6, 7)))
    got = gc.gradcam_weights(feats, head, (6, 7), 'cpu').numpy()
    assert got.shape == want.shape == (8, 5)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('pass_share', [0.0, 0.6, 1.0])
def test_grad_cam_equals_jax(pass_share):
    rng = np.random.default_rng(0)
    feats = rng.normal(0, 1, (3, 7, 7, 16)).astype(np.float32)
    weights = rng.normal(0, 1, (16, 5)).astype(np.float32)
    is_pass = rng.random((3, 5)) < pass_share
    want = np.asarray(jax_gc.grad_cam(feats, weights, is_pass))
    got = gc.grad_cam(_t(feats), _t(weights), _t(is_pass)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
