"""The port's ADP HistoSegNet path against the JAX package: the registry
copies, ``gaussian_blur``, ``cs_gradcam``, ``modify_by_htt`` on seeded
numpy inputs, and ``ADPHSNSegmenter.segment_batch`` on bridged weights
for both model families, on the fixture of the reference's own ADP test
(48^2 synthetic images, batch 2, CRF (1.5, 3, 4, 13, 10) x 2 iterations:
the exact dense structure, f32 on both sides).

Tolerances: elementwise ops 1e-5 (f32, other order of adds); the CAM
stage's unaries 1e-4 (another conv stack); labels agree >= 0.99
(measured 1.0 for X1.7 and for VGG16 morph and func)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from test_torch_gradcam import bridged_handles
from wsss_tpu.data import registry as jax_registry
from wsss_tpu.data.pipeline import SyntheticWSSS
from wsss_tpu.methods import hsn as jax_hsn
from wsss_tpu.ops import cues as jax_cues
from wsss_tpu.ops import filters as jax_filters
from wsss_tpu.ops import gradcam as jax_gc
from wsss_tpu.ops.crf import config as jax_config
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods import hsn
from wsss_tpu_torch.ops import cues, filters
from wsss_tpu_torch.ops import gradcam as gc
from wsss_tpu_torch.ops.crf import config


def test_registry_copies_equal():
    for name in ('ADP_CLASSES_X17', 'ADP_CLASSES_VGG16', 'ADP_MORPH_CLASSES',
                 'ADP_FUNC_CLASSES', 'ADP_BG_EXCEPTION',
                 'ADP_ADIPOSE_CLASSES', 'PALETTES'):
        assert getattr(registry, name) == getattr(jax_registry, name), name
    assert sorted(registry.REGISTRY) == sorted(jax_registry.REGISTRY)
    for name in registry.REGISTRY:
        assert (dataclasses.asdict(registry.get(name))
                == dataclasses.asdict(jax_registry.get(name))), name
    for family in ('X1.7', 'VGG16'):
        got = registry.adp_index_maps(family)
        want = jax_registry.adp_index_maps(family)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for ds in ('ADP-morph', 'ADP-func'):
        assert (config.hsn_config(ds).astuple()
                == jax_config.hsn_config(ds).astuple())


@pytest.mark.parametrize('shape,sigma', [((2, 17, 23), 2.0), ((5, 6), 2.0),
                                         ((3, 30, 30), 0.8)])
def test_gaussian_blur_matches_jax_and_scipy(shape, sigma):
    """(5, 6) is smaller than the kernel's radius of 8: the mirror wraps
    more than once."""
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    got = filters.gaussian_blur(torch.from_numpy(x), sigma=sigma).numpy()
    sp = np.stack([scipy.ndimage.gaussian_filter(p, sigma, mode='reflect')
                   for p in x.reshape((-1,) + shape[-2:])]).reshape(shape)
    np.testing.assert_allclose(got, sp, atol=1e-5)
    if min(shape[-2:]) > 8:     # jnp.pad cannot mirror past one period
        want = np.asarray(jax_filters.gaussian_blur(jnp.asarray(x),
                                                    sigma=sigma))
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('other_ind', [-1, 1])
def test_cs_gradcam_matches_jax(other_ind):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 9, 11, 5)).astype(np.float32)
    x[0, :3] = 0.0                              # all-tied pixels
    x[1, 2, :, 3] = x[1, 2, :, 0]               # a tied maximum or not
    want = np.asarray(jax_gc.cs_gradcam(jnp.asarray(x), other_ind=other_ind))
    got = gc.cs_gradcam(torch.from_numpy(x), other_ind=other_ind).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize('kind', ['morph', 'func', 'morph_relu_resized'])
def test_modify_by_htt_matches_jax(kind):
    rng = np.random.default_rng(2)
    hw = (12, 12) if kind == 'morph_relu_resized' else (24, 24)
    cam = rng.uniform(0, 1, (2,) + hw + (6,)).astype(np.float32)
    imgs = rng.uniform(150, 255, (2, 24, 24, 3)).astype(np.float32)
    if kind == 'func':
        kw = dict(exception_inds=(2, 3, 4), bg_ind=0, other_ind=1,
                  adipose_cam=rng.uniform(0, 0.2, (2,) + hw
                                          ).astype(np.float32))
    else:
        kw = dict(exception_inds=(4, 5), bg_ind=0,
                  relu_bg=kind != 'morph')
    want = np.asarray(jax_cues.modify_by_htt(
        jnp.asarray(cam), jnp.asarray(imgs),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}))
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    cam_t = torch.from_numpy(cam)
    got = cues.modify_by_htt(cam_t, torch.from_numpy(imgs), **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(cam_t.numpy(), cam)   # input untouched


def _small_cfg(mod):
    return mod.CRFConfig(1.5, 3, 4.0, 13, 10, iterations=2)


@pytest.mark.parametrize('family,n_cls', [('X1.7', 51), ('VGG16', 31)])
def test_adp_segment_batch_matches_jax(family, n_cls):
    size = 48
    jh, th = bridged_handles(family, n_cls, size, seed=3)
    # thresholds on the handle: half the classes pass easily, half hardly
    th_np = np.where(np.arange(n_cls) % 2, 0.3, 0.6).astype(np.float32)
    jh.thresholds = jnp.asarray(th_np)
    th.thresholds = torch.from_numpy(th_np)
    jseg = jax_hsn.ADPHSNSegmenter(jh, family, cfg_morph=_small_cfg(jax_config),
                                   cfg_func=_small_cfg(jax_config))
    tseg = hsn.ADPHSNSegmenter(th, family, cfg_morph=_small_cfg(config),
                               cfg_func=_small_cfg(config), device='cpu')
    batch = next(SyntheticWSSS('ADP-morph', size=size, n_images=2).batches(2))
    imgs = np.asarray(batch.images, np.float32)
    want_cs = jseg._batch_fn(jnp.asarray(imgs))
    got_cs = tseg.probs(torch.from_numpy(imgs))
    for got, want, n in zip(got_cs, want_cs, (29, 5)):
        assert got.shape == (2, size, size, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    want = jseg.segment_batch(imgs)
    got = tseg.segment_batch(imgs)
    for name, g, w, n in zip(('morph', 'func'), got, want, (29, 5)):
        assert g.dtype == torch.int32 and g.shape == (2, size, size)
        assert int(g.min()) >= 0 and int(g.max()) < n
        agree = (g.numpy() == np.asarray(w)).mean()
        print(f'{family} {name} label agreement {agree:.6f}')
        assert agree >= 0.99, (name, agree)


def test_adp_segmenter_defaults():
    """Default CRFs are the ADP HistoSegNet configs; the device defaults
    to the card and the handle must live on the segmenter's device."""
    _, th = bridged_handles('X1.7', 51, 32, seed=4)
    seg = hsn.ADPHSNSegmenter(th, 'X1.7', device='cpu')
    assert seg.cfg_morph == config.hsn_config('ADP-morph')
    assert seg.cfg_func == config.hsn_config('ADP-func')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            hsn.ADPHSNSegmenter(th, 'X1.7')
