"""The port's exact bilateral structures, its structure choice and the
whole of ``mean_field``'s routing against the JAX package, on seeded
numpy inputs.

Tolerances.  ``DenseBilateral`` and ``DirectBilateral`` are f32 on both
sides: filters within 1e-4 relative (measured <= 3e-7; the window adds
the offsets in the reference's scan order).  ``mean_field`` on those
structures: Q within 1e-4.  On the scatter grid the reference scatters in bf16, one rounding per pixel
added: on the toy image's two flat colour regions hundreds of pixels
share a cell and its sums lose percents, which the mean field's compat
scale carries into Q.  So the f32 port's Q is held within 1e-1 (measured
5.9e-2) and its labels >= 0.99 (measured 1.0), and the check of the
port's arithmetic is the rounding switch, which rounds where and in the
order the reference does: Q within 1e-4 (measured 2e-6).
``crf_label_refine``: labels agree >= 0.99 (measured 1.0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsss_tpu.ops.crf import config as jax_config
from wsss_tpu.ops.crf import meanfield as jax_mf
from wsss_tpu.ops.crf import native as jax_native
from wsss_tpu.ops.crf import reference as jax_reference
from wsss_tpu_torch.ops.crf import config, native, reference
from wsss_tpu_torch.ops.crf import meanfield as mf


def _toy_problem(h=10, w=10, c=3, seed=0):
    """A structured two-region image with noisy unaries (the fixture of
    the reference's CRF tests)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 2] = (40, 40, 200)
    img[:, w // 2:] = (200, 40, 40)
    img += rng.normal(0, 8, img.shape).astype(np.float32)
    img = np.clip(img, 0, 255)
    probs = np.full((h, w, c), 0.1, np.float32)
    probs[:, : w // 2, 1] = 0.6
    probs[:, w // 2:, 2] = 0.6
    flip = rng.random((h, w)) < 0.2
    probs[flip] = rng.dirichlet(np.ones(c), size=flip.sum()).astype(
        np.float32)
    return probs, img


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_dense_bilateral_matches_jax():
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (2, 9, 11, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (2, 9, 11, 4)).astype(np.float32)
    got = mf.DenseBilateral(torch.from_numpy(imgs), 3.0, 30.0).filter(
        torch.from_numpy(x)).numpy()
    for b in range(2):
        jd = jax_mf.DenseBilateral(jnp.asarray(imgs[b]), 3.0, 30.0)
        want = np.asarray(jd.filter(jnp.asarray(x[b])))
        assert _rel(got[b], want) <= 1e-4
        one = mf.DenseBilateral(torch.from_numpy(imgs[b]), 3.0, 30.0)
        np.testing.assert_allclose(one.K[0].numpy(), np.asarray(jd.K),
                                   atol=1e-6)
        assert _rel(one.filter(torch.from_numpy(x[b])).numpy(), want) <= 1e-4


@pytest.mark.parametrize('path', ['cached', 'recompute'])
def test_direct_bilateral_matches_jax(path, monkeypatch):
    """The window (one path: weights computed at every filter) against
    both of the reference's paths: its cached weight maps, and its scan
    over the cache budget."""
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 255, (2, 14, 12, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (2, 14, 12, 4)).astype(np.float32)
    sxy, srgb = 1.7, 25.0
    if path != 'cached':
        monkeypatch.setattr(jax_mf.DirectBilateral, '_CACHE_BUDGET', 0)
    td = mf.DirectBilateral(torch.from_numpy(imgs), sxy, srgb)
    got = td.filter(torch.from_numpy(x)).numpy()
    for b in range(2):
        jd = jax_mf.DirectBilateral(jnp.asarray(imgs[b]), sxy, srgb)
        assert (jd.cache is not None) == (path == 'cached')
        assert jd.offs == td.offs
        np.testing.assert_allclose(jd.wspace, td.wspace, rtol=1e-6)
        want = np.asarray(jd.filter(jnp.asarray(x[b])))
        err = _rel(got[b], want)
        print(f'{path} image {b}: max rel err {err:.3e}')
        assert err <= 1e-4


def test_shift2d_matches_jax():
    x = np.random.default_rng(2).normal(0, 1, (6, 7, 2)).astype(np.float32)
    for dy, dx in ((0, 0), (2, -3), (-1, 4), (-6, 0), (7, 7)):
        np.testing.assert_array_equal(
            mf._shift2d(torch.from_numpy(x), dy, dx).numpy(),
            np.asarray(jax_mf._shift2d(jnp.asarray(x), dy, dx)))


def _structure_cases():
    """(id, sxy, srgb, hw) for every config of ops/crf/config.py at the
    sizes its stack runs."""
    c = config
    cases = []
    for (ds, mt), cfg in c.HSN_TEST.items():
        sizes = ([(224, 224), (321, 321)] if ds.startswith('ADP')
                 else [(224, 224)] if mt == 'M7' else [(321, 321)])
        cases += [(f'hsn-{ds}-{mt}-{hw[0]}', cfg, hw) for hw in sizes]
    for ds, cfg in c.SEC_TEST.items():
        cases += [(f'sec-{ds}-{hw[0]}', cfg, hw)
                  for hw in ((321, 321), (375, 500))]
    cases += [('dsrg-test', c.DSRG_TEST, (321, 321)),
              ('sec-train', c.SEC_TRAIN_DEFAULT, (41, 41)),
              ('dsrg-train', c.DSRG_TRAIN, (41, 41)),
              ('irn-label', c.IRN_LABEL, (321, 321)),
              ('irn-label-300', c.IRN_LABEL, (300, 300))]
    return cases


_KIND = {'dense': jax_mf.DenseBilateral, 'direct': jax_mf.DirectBilateral,
         'grid': jax_mf.BilateralGrid}


@pytest.mark.parametrize('name,cfg,hw', _structure_cases(),
                         ids=[c[0] for c in _structure_cases()])
def test_make_bilateral_choice_matches_jax(name, cfg, hw):
    """The structure each config gets at its production size, the native
    route's test and the MXU routing equal the reference's."""
    kind = mf.bilateral_structure(hw, cfg.bi_sxy, cfg.bi_srgb)
    want = jax_mf.make_bilateral(jnp.zeros(hw + (3,)), cfg.bi_sxy,
                                 cfg.bi_srgb)
    assert type(want) is _KIND[kind], (name, kind)
    assert mf._routes_to_grid(hw, cfg.bi_sxy, cfg.bi_srgb) == \
        jax_mf._routes_to_grid(hw, cfg.bi_sxy, cfg.bi_srgb)
    assert mf._grid_shape(hw, cfg.bi_sxy, cfg.bi_srgb) == \
        jax_mf._grid_shape(hw, cfg.bi_sxy, cfg.bi_srgb)
    if kind == 'direct':
        port = mf.DirectBilateral(torch.zeros((8, 8, 3)), cfg.bi_sxy,
                                  cfg.bi_srgb)
        assert port.offs == want.offs
    # the reference builds its library at first use, the port only loads
    # it: ask the reference first
    want_native = jax_mf._fine_color_native_ok(np.zeros(1), hw, cfg)
    assert mf._fine_color_native_ok(hw, cfg) == want_native


def test_make_bilateral_builds_each_structure():
    small = torch.zeros((2, 32, 32, 3))
    big = torch.zeros((1, 112, 112, 3))
    assert isinstance(mf.make_bilateral(small, 40, 13), mf.DenseBilateral)
    assert isinstance(mf.make_bilateral(big, 40, 13), mf.BilateralGrid)
    assert isinstance(mf.make_bilateral(big[0], 1.7, 13), mf.DirectBilateral)
    # ADP's srgb 4: 68^3 colour cells a spatial cell, so the window
    assert mf.bilateral_structure((112, 112), 10, 4) == 'direct'
    with pytest.raises(ValueError, match='intractable'):
        mf.make_bilateral(big, 40, 0.5)


def test_messages_match_jax():
    probs, img = _toy_problem(12, 14, seed=1)
    Q = probs / probs.sum(-1, keepdims=True)
    for ex in (True, False):
        want = np.asarray(jax_mf.gaussian_message(jnp.asarray(Q), 2.0,
                                                  exclude_self=ex))
        got = mf.gaussian_message(torch.from_numpy(Q), 2.0,
                                  exclude_self=ex).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        want = np.asarray(jax_mf.bilateral_message(
            jnp.asarray(Q), jnp.asarray(img), 3.0, 40.0, exclude_self=ex))
        got = mf.bilateral_message(torch.from_numpy(Q),
                                   torch.from_numpy(img), 3.0, 40.0,
                                   exclude_self=ex).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    want = np.asarray(jax_mf._bilateral_filter_raw(
        jnp.asarray(Q), jnp.asarray(img), 3.0, 40.0))
    got = mf._bilateral_filter_raw(torch.from_numpy(Q),
                                   torch.from_numpy(img), 3.0, 40.0).numpy()
    assert _rel(got, want) <= 1e-4


_MF_CASES = {
    # dense kernel (10x10), direct window (104x100, sxy 1.2), scatter grid
    'dense': (config.CRFConfig(2, 3, 4, 30, 5, iterations=3), (10, 10)),
    'dense_sec_train': (config.SEC_TRAIN_DEFAULT, (10, 10)),
    'direct': (config.CRFConfig(1.5, 3, 1.2, 30, 5, iterations=2),
               (104, 100)),
    'grid': (config.CRFConfig(1.5, 3, 12.0, 40, 6, iterations=2),
             (104, 100)),
}


@pytest.mark.parametrize('exclude_self', [True, False])
@pytest.mark.parametrize('case', list(_MF_CASES))
def test_mean_field_matches_jax(case, exclude_self):
    """mean_field on each per-structure route against the reference's
    ``_mean_field_single`` (through its ``mean_field``), batched against
    per image, with ``exclude_self`` both ways."""
    cfg, hw = _MF_CASES[case]
    kind = mf.bilateral_structure(hw, cfg.bi_sxy, cfg.bi_srgb)
    assert kind == case.split('_')[0]
    pairs = [_toy_problem(*hw, c=3, seed=s) for s in (3, 4)]
    probs = np.stack([p[0] for p in pairs])
    imgs = np.stack([p[1] for p in pairs])
    jcfg = jax_config.CRFConfig(*cfg.astuple())
    want = np.stack([np.asarray(jax_mf.mean_field(
        jnp.asarray(probs[b]), jnp.asarray(imgs[b]), jcfg,
        exclude_self=exclude_self)) for b in range(2)])
    got = mf.mean_field(torch.from_numpy(probs), torch.from_numpy(imgs),
                        cfg, exclude_self=exclude_self).numpy()
    q_atol = 1e-1 if kind == 'grid' else 1e-4
    err = np.abs(got - want).max()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    print(f'{case} exclude_self={exclude_self}: max |dQ| {err:.3e}, '
          f'labels agree {agree:.5f}')
    assert err <= q_atol and agree >= 0.99
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    if kind == 'grid':
        rounded = mf.mean_field(
            torch.from_numpy(probs), torch.from_numpy(imgs), cfg,
            exclude_self=exclude_self, ref_round=True).numpy()
        err = np.abs(rounded - want).max()
        print(f'{case} rounding switch: max |dQ| {err:.3e}')
        assert err <= 1e-4
    one = mf.mean_field(torch.from_numpy(probs[1]),
                        torch.from_numpy(imgs[1]), cfg,
                        exclude_self=exclude_self).numpy()
    np.testing.assert_allclose(one, got[1], atol=1e-6)
    # a different result with the self term kept: the switch is live
    other = mf.mean_field(torch.from_numpy(probs[1]),
                          torch.from_numpy(imgs[1]), cfg,
                          exclude_self=not exclude_self).numpy()
    assert np.abs(other - one).max() > 1e-4


@pytest.mark.parametrize('exclude_self', [True, False])
def test_mean_field_matches_exact(exclude_self):
    """The dense route is the exact mean field: against the numpy
    O(N^2) spec (the port's copy equals the reference's)."""
    cfg = config.CRFConfig(2, 3, 4, 30, 5, iterations=3)
    probs, img = _toy_problem(10, 10, seed=3)
    want = reference.mean_field_exact(probs, img, cfg,
                                      exclude_self=exclude_self)
    np.testing.assert_array_equal(want, jax_reference.mean_field_exact(
        probs, img, cfg, exclude_self=exclude_self))
    got = mf.mean_field(torch.from_numpy(probs), torch.from_numpy(img), cfg,
                        exclude_self=exclude_self).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_mean_field_chunks_a_batch(monkeypatch):
    """A batch over the memory bound runs in chunks with the same bits."""
    cfg, hw = _MF_CASES['direct']
    pairs = [_toy_problem(*hw, c=3, seed=s) for s in (5, 6, 7)]
    probs = torch.from_numpy(np.stack([p[0] for p in pairs]))
    imgs = torch.from_numpy(np.stack([p[1] for p in pairs]))
    whole = mf.mean_field(probs, imgs, cfg)
    assert mf._single_chunk(3, hw, 3, cfg) == 3
    monkeypatch.setattr(mf, '_SINGLE_CHUNK_BYTES', 2 * hw[0] * hw[1] * 3 * 4)
    assert mf._single_chunk(3, hw, 3, cfg) == 2
    np.testing.assert_allclose(mf.mean_field(probs, imgs, cfg).numpy(),
                               whole.numpy(), atol=1e-6)


def test_crf_label_refine_matches_jax():
    """IRNet's label CRF with coarser colour cells (srgb 25 for 5, 3
    iterations) at 112x104: the scatter grid, 5 x 5 x 15^3 cells, too few
    for the native route on either side."""
    cfg = config.CRFConfig(3, 3, 50, 25, 10, 3)
    hw = (112, 104)
    assert mf.bilateral_structure(hw, cfg.bi_sxy, cfg.bi_srgb) == 'grid'
    _, img = _toy_problem(*hw, seed=8)
    rng = np.random.default_rng(9)
    labels = np.zeros(hw, np.int32)
    labels[:, hw[1] // 2:] = 1
    noise = rng.random(hw) < 0.15
    labels[noise] = rng.integers(0, 3, noise.sum())
    want = np.asarray(jax_mf.crf_label_refine(
        jnp.asarray(img), jnp.asarray(labels), 3,
        jax_config.CRFConfig(*cfg.astuple())))
    got = mf.crf_label_refine(torch.from_numpy(img),
                              torch.from_numpy(labels), 3, cfg)
    assert got.dtype == torch.int32 and tuple(got.shape) == hw
    agree = (got.numpy() == want).mean()
    print(f'crf_label_refine label agreement {agree:.6f}; changed '
          f'{(want != labels).mean():.3f} of the input labels')
    assert agree >= 0.99
    assert (want != labels).mean() > 0.05       # the CRF did some work
    both = mf.crf_label_refine(
        torch.from_numpy(np.stack([img, img])),
        torch.from_numpy(np.stack([labels, labels])), 3, cfg)
    assert torch.equal(both[0], got) and torch.equal(both[1], got)


def test_native_route(monkeypatch):
    """Where the C++ library is built, a fine-colour grid config on CPU
    tensors goes to it (the reference's choice) and gives the reference's
    bits; switched off, the same call runs the scatter grid."""
    if not native.available() and not native.build():
        pytest.skip('native/libwsssnative.so does not load or build here')
    np.testing.assert_array_equal(
        native.permutohedral_filter(np.eye(4, 3), np.ones((4, 2))),
        jax_native.permutohedral_filter(np.eye(4, 3), np.ones((4, 2))))
    cfg = config.CRFConfig(3, 3, 50, 5, 10, 2)           # IRN_LABEL, 2 its
    hw = (160, 150)                 # 6 x 5 x 56^3 = 5.3 M cells
    assert mf._fine_color_native_ok(hw, cfg)
    probs, img = _toy_problem(*hw, seed=10)
    for ex in (True, False):
        want = np.asarray(jax_mf.mean_field(
            jnp.asarray(probs), jnp.asarray(img),
            jax_config.CRFConfig(*cfg.astuple()), exclude_self=ex))
        got = mf.mean_field(torch.from_numpy(probs), torch.from_numpy(img),
                            cfg, exclude_self=ex)
        np.testing.assert_array_equal(got.numpy(), want)
    calls = []
    monkeypatch.setattr(mf._native, 'mean_field_native',
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(mf, '_NATIVE_DISABLED', True)
    assert not mf._fine_color_native_ok(hw, cfg)
    q = mf.mean_field(torch.from_numpy(probs), torch.from_numpy(img), cfg)
    assert not calls and q.shape == probs.shape
