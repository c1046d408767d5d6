"""The port's IRNet inference stages (``wsss_tpu_torch/methods/irnet.py``)
against the JAX package's on the same numpy inputs, with the classifiers'
flax variables carried across by the bridge.

Tolerances: CAM keys equal, maps within 1e-4 (measured ~1e-6);
``eval_cam_pred`` and ``affinity_labels`` equal; ir-labels agree on
>= 0.99 of the pixels (the CRF's float32 sums differ in order between
the packages, so pixels at a near tie may flip; measured 1.0); sem-seg
labels on >= 0.999 (the walk's float32 products, then an argmax)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from test_torch_models import perturbed_variables
from test_torch_sharded_crf import cpu_mesh
from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu.methods import irnet as jirnet
from wsss_tpu.methods.gradcam_cues import _ClassifierHandle as JHandle
from wsss_tpu.models import build_classifier as jax_build
from wsss_tpu.ops.crf import config as jax_config
from wsss_tpu.ops.random_walk import PathIndex as JPathIndex
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods import irnet
from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
from wsss_tpu_torch.ops.crf import config
from wsss_tpu_torch.ops.crf import meanfield as mf
from wsss_tpu_torch.ops.random_walk import PathIndex

CAM_TOL = 1e-4
IR_FLOOR = 0.99
SEM_FLOOR = 0.999
# coarse colour cells (srgb 25 for IRN_LABEL's 5) and 3 iterations: the
# scatter grid at 112x104 stays small on both sides
COARSE = config.CRFConfig(3, 3, 50, 25, 10, 3)


def _handles(model_type, n, size, seed, thresholds):
    """(JAX handle, port handle on the CPU) of the same perturbed
    classifier variables and thresholds."""
    _, variables = perturbed_variables(model_type, n, size, seed)
    jh = JHandle(jax_build(model_type, n),
                 jax.tree_util.tree_map(jnp.asarray, variables), thresholds,
                 size)
    th = _ClassifierHandle.from_flax(model_type, variables, thresholds, size,
                                     device='cpu')
    return jh, th


def _hold_cam(got, want, name):
    np.testing.assert_array_equal(got['keys'], want['keys'])
    for k in ('cam', 'high_res'):
        assert got[k].shape == np.asarray(want[k]).shape, (name, k)
        d = float(np.abs(got[k] - np.asarray(want[k])).max()) \
            if got[k].size else 0.0
        print(f'{name} {k} {got[k].shape}: keys {got["keys"].tolist()}, max '
              f'|diff| {d:.3e}')
        assert d <= CAM_TOL


def test_strided_sizes():
    for hw, s in (((512, 512), 4), ((321, 321), 4), ((375, 500), 16)):
        assert irnet.get_strided_size(hw, s) == jirnet.get_strided_size(hw, s)
        assert (irnet.get_strided_up_size(hw, s)
                == jirnet.get_strided_up_size(hw, s))


def test_make_cam_voc_equals_jax():
    """VOC VGG16 at 64^2 and a 56x64 image, scales (1.0, 0.5): with tags,
    without (thresholds pass every other class), and the argmax fallback
    when nothing passes (vgg16_cam.py:41-42)."""
    th = np.where(np.arange(20) % 2 == 0, 0.0, 1.01).astype(np.float32)
    jh, th_ = _handles('VGG16', 20, 64, seed=0, thresholds=th)
    spec = registry.get('VOC2012')
    from wsss_tpu.data import registry as jreg
    jci = jirnet.CAMInference(jh, jreg.get('VOC2012'), 'VGG16',
                              scales=(1.0, 0.5))
    ci = irnet.CAMInference(th_, spec, 'VGG16', scales=(1.0, 0.5),
                            device='cpu')
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (2, 56, 64, 3)).astype(np.float32)
    tags = np.zeros((2, 20), np.float32)
    tags[0, [3, 7]] = 1
    tags[1, [12]] = 1
    for i, (g, w) in enumerate(zip(ci.make_cam_batch(imgs, tags),
                                   jci.make_cam_batch(imgs, tags))):
        _hold_cam(g, w, f'tags, image {i}')
    assert list(g['keys']) == [12] and g['cam'].shape == (1, 14, 16)
    _hold_cam(ci.make_cam(imgs[0], None), jci.make_cam(imgs[0], None),
              'thresholds')
    jh.thresholds = jnp.full_like(jh.thresholds, 1.01)
    th_.thresholds = torch.full_like(th_.thresholds, 1.01)
    got = ci.make_cam(imgs[1], None)
    _hold_cam(got, jci.make_cam(imgs[1], None), 'argmax fallback')
    assert len(got['keys']) == 1


@pytest.mark.parametrize('htt', ['morph', 'func'])
def test_make_cam_adp_x17_equals_jax(htt):
    """ADP X1.7 at 48^2 (51-way head, the x17_to_31 selection) with the
    synthesized background (morph, relu) / background + other (func):
    morph from tags, func from thresholds."""
    th = np.where(np.arange(51) % 3 == 0, 0.0, 1.01).astype(np.float32)
    jh, th_ = _handles('X1.7', 51, 48, seed=1, thresholds=th)
    from wsss_tpu.data import registry as jreg
    name = f'ADP-{htt}'
    jci = jirnet.CAMInference(jh, jreg.get(name), 'X1.7', scales=(1.0, 0.5),
                              adp_htt=htt)
    ci = irnet.CAMInference(th_, registry.get(name), 'X1.7',
                            scales=(1.0, 0.5), adp_htt=htt, device='cpu')
    img = np.random.default_rng(1).uniform(0, 255, (48, 48, 3)).astype(
        np.float32)
    img[:16] = 250.0                              # a white band: background
    tags = None
    if htt == 'morph':
        tags = np.zeros(registry.get(name).n_fg_classes, np.float32)
        tags[[0, 5]] = 1
    got = ci.make_cam(img, tags)
    _hold_cam(got, jci.make_cam(img, tags), name)
    nbg = 1 if htt == 'morph' else 2
    assert list(got['keys'][:nbg]) == list(range(nbg))
    assert len(got['keys']) > nbg


def _cam_dict(rng, keys, hw, strided=True):
    c = len(keys)
    hr = rng.random((c,) + hw).astype(np.float32)
    hr /= hr.max(axis=(1, 2), keepdims=True)
    d = {'keys': np.asarray(keys, np.int64), 'high_res': hr}
    d['cam'] = hr[:, ::4, ::4].copy() if strided else hr
    return d


@pytest.mark.parametrize('dataset', ['VOC2012', 'ADP-morph', 'DeepGlobe'])
def test_eval_cam_pred_equals_jax(dataset):
    rng = np.random.default_rng(3)
    d = _cam_dict(rng, [0, 2, 5], (20, 24))
    np.testing.assert_array_equal(irnet.eval_cam_pred(d, dataset, 0.15),
                                  jirnet.eval_cam_pred(d, dataset, 0.15))
    empty = {'keys': np.empty(0, np.int64), 'cam': np.empty(0),
             'high_res': np.empty(0)}
    if dataset != 'VOC2012':
        assert irnet.eval_cam_pred(empty, dataset, 0.15) is None


def _structured(hw, seed):
    """A blocky image and CAMs that follow its blocks, with noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 2] = (40, 40, 200)
    img[:, w // 2:] = (200, 60, 40)
    img[h // 2:, : w // 3] = (50, 200, 60)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
        np.float32)
    # confident blocks, a block between the two thresholds (ignored on
    # VOC) and the rest below the background threshold
    hr = rng.random((2, h, w)).astype(np.float32) * 0.04
    hr[0, : h // 2, : w // 2] += 0.6 + 0.3 * rng.random((h // 2, w // 2))
    hr[1, :, w // 2:] += 0.6 + 0.3 * rng.random((h, w - w // 2))
    hr[0, h // 2:, : w // 3] += 0.2
    return img, hr


@pytest.mark.parametrize('dataset,hw', [('VOC2012', (112, 104)),
                                        ('ADP-morph', (112, 104)),
                                        ('DeepGlobe', (160, 152))])
def test_cam_to_ir_label_equals_jax(dataset, hw):
    """On the scatter grid (VOC, ADP at 112x104) and, for DeepGlobe, the
    reference's square (h/4, h/4) resize of image and strided CAM."""
    img, hr = _structured(hw, seed=5)
    if dataset == 'VOC2012':
        keys = [4, 9]
    elif dataset == 'ADP-morph':
        keys, hr = [0, 3, 6], np.concatenate([hr[:1] * 0.5, hr])
    else:
        keys = [1, 3]
    d = {'keys': np.asarray(keys, np.int64), 'high_res': hr,
         'cam': hr[:, ::4, ::4].copy()}
    if dataset != 'DeepGlobe':
        assert mf.bilateral_structure(hw, COARSE.bi_sxy,
                                      COARSE.bi_srgb) == 'grid'
    want = jirnet.cam_to_ir_label(img, d, dataset, conf_fg_thres=0.5,
                                  conf_bg_thres=0.05,
                                  cfg=jax_config.CRFConfig(*COARSE.astuple()))
    got = irnet.cam_to_ir_label(img, d, dataset, conf_fg_thres=0.5,
                                conf_bg_thres=0.05, cfg=COARSE, device='cpu')
    assert got.dtype == np.uint8 and got.shape == want.shape
    agree = (got == want).mean()
    print(f'cam_to_ir_label {dataset} {want.shape}: agreement {agree:.6f}, '
          f'labels {np.unique(want).tolist()}')
    assert agree >= IR_FLOOR
    assert len(np.unique(want)) > 1
    empty = {'keys': np.empty(0, np.int64)}
    assert (irnet.cam_to_ir_label(img, empty, dataset, 0.5,
                                  device='cpu') == 255).all()


def test_affinity_labels_equal_jax():
    rng = np.random.default_rng(6)
    lab = rng.integers(0, 3, (12, 14)).astype(np.int64)
    lab[0] = 255
    lab[:, 9:] = 1
    got = irnet.affinity_labels(lab, PathIndex(3), 21)
    want = jirnet.affinity_labels(lab, JPathIndex(3), 21)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    total = sum(got)
    assert total.max() <= 1 and all(x.sum() > 0 for x in got)


@pytest.mark.parametrize('dataset,cam_hw,edge_hw,orig_hw', [
    ('VOC2012', (16, 16), (16, 16), (64, 62)),
    ('ADP-func', (15, 16), (8, 8), (60, 64)),
    ('DeepGlobe', (48, 42), (12, 12), (192, 168))])
def test_make_sem_seg_equals_jax(dataset, cam_hw, edge_hw, orig_hw):
    """VOC with its threshold channel; ADP with the edge resized onto the
    CAM grid; DeepGlobe's walk_downsample (/6) and /4 output; then the
    empty-keys returns."""
    rng = np.random.default_rng(7)
    cam = rng.random((3,) + cam_hw).astype(np.float32) * 0.3
    cam[0, :, : cam_hw[1] // 3] += 0.7
    cam[1, :, cam_hw[1] // 3:] += 0.5
    cam[2, cam_hw[0] // 2:] += 0.6
    edge = (rng.random(edge_hw) * 0.5).astype(np.float32)
    edge[:, edge_hw[1] // 2] = 0.9
    keys = np.array([0, 2, 4] if dataset != 'DeepGlobe' else [1, 2, 5])
    d = {'keys': keys, 'cam': cam, 'high_res': cam}
    kw = dict(beta=10.0, exp_times=3, sem_seg_bg_thres=0.3)
    want = jirnet.make_sem_seg(jnp.asarray(edge), d, dataset, orig_hw, **kw)
    got = irnet.make_sem_seg(torch.from_numpy(edge), d, dataset, orig_hw,
                             device='cpu', **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    agree = (got == want).mean()
    print(f'make_sem_seg {dataset} {want.shape}: agreement {agree:.6f}, '
          f'labels {np.unique(want).tolist()}')
    assert agree >= SEM_FLOOR
    assert len(np.unique(want)) > 1
    empty = {'keys': np.empty(0), 'cam': np.empty(0),
             'high_res': np.empty(0)}
    e_got = irnet.make_sem_seg(torch.from_numpy(edge), empty, dataset,
                               orig_hw, device='cpu')
    e_want = jirnet.make_sem_seg(jnp.asarray(edge), empty, dataset, orig_hw)
    np.testing.assert_array_equal(e_got, e_want)
    assert e_got.dtype == np.uint8


def _sem_seg_problem(cam_hw, edge_hw, seed=7):
    rng = np.random.default_rng(seed)
    cam = rng.random((3,) + cam_hw).astype(np.float32) * 0.3
    cam[0, :, : cam_hw[1] // 3] += 0.7
    cam[1, :, cam_hw[1] // 3:] += 0.5
    cam[2, cam_hw[0] // 2:] += 0.6
    edge = (rng.random(edge_hw) * 0.5).astype(np.float32)
    edge[:, edge_hw[1] // 2] = 0.9
    return {'keys': np.array([0, 2, 4]), 'cam': cam, 'high_res': cam}, edge


def test_make_sem_seg_on_a_mesh_equals_jax():
    """The walk's matrix cut over a (2, 1) mesh, as ``--mesh 2`` builds
    it: labels equal the JAX sharded run's and the port's unsharded
    run's on >= SEM_FLOOR of the pixels."""
    d, edge = _sem_seg_problem((16, 16), (16, 16))
    kw = dict(beta=10.0, exp_times=3, sem_seg_bg_thres=0.3)
    jmesh = JaxMesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                    ('data', 'model'))
    want = jirnet.make_sem_seg(jnp.asarray(edge), d, 'VOC2012', (64, 62),
                               mesh=jmesh, **kw)
    got = irnet.make_sem_seg(torch.from_numpy(edge), d, 'VOC2012', (64, 62),
                             mesh=cpu_mesh((2, 1), ('data', 'model')),
                             device='cpu', **kw)
    single = irnet.make_sem_seg(torch.from_numpy(edge), d, 'VOC2012',
                                (64, 62), device='cpu', **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape == (64, 62)
    assert (got == want).mean() >= SEM_FLOOR
    assert (got == single).mean() >= SEM_FLOOR
    assert len(np.unique(got)) > 1


def test_make_cam_batch_on_a_mesh_equals_jax():
    """3 images of 56x64 cut over 2 shards (padded to 4), VOC VGG16 at
    64^2, scale 1.0: against the JAX sharded run and the port's
    unsharded one, within CAM_TOL."""
    th = np.where(np.arange(20) % 2 == 0, 0.0, 1.01).astype(np.float32)
    jh, th_ = _handles('VGG16', 20, 64, seed=0, thresholds=th)
    from wsss_tpu.data import registry as jreg
    jci = jirnet.CAMInference(jh, jreg.get('VOC2012'), 'VGG16',
                              scales=(1.0,))
    ci = irnet.CAMInference(th_, registry.get('VOC2012'), 'VGG16',
                            scales=(1.0,), device='cpu')
    imgs = np.random.default_rng(1).uniform(
        0, 255, (3, 56, 64, 3)).astype(np.float32)
    jmesh = JaxMesh(np.asarray(jax.devices()[:2]), ('data',))
    got = ci.make_cam_batch(imgs, None, mesh=cpu_mesh((2,), ('data',)))
    want = jci.make_cam_batch(imgs, None, mesh=jmesh)
    single = ci.make_cam_batch(imgs, None)
    assert len(got) == 3
    for i, (g, w, s_) in enumerate(zip(got, want, single)):
        _hold_cam(g, w, f'mesh, image {i}')
        _hold_cam(g, s_, f'mesh against one device, image {i}')


def test_cam_to_ir_label_at_adp_native_size_raises_as_jax():
    """At ADP's native 1088^2 the ir-label CRF (IRN_LABEL) has no
    tractable structure in either package: the scatter grid would pass
    the 80 M-cell routing limit and the window has 70 686 offsets."""
    hw = (1088, 1088)
    img = np.zeros(hw + (3,), np.float32)
    hr = np.zeros((3,) + hw, np.float32)
    hr[1, :500] = 1.0
    d = {'keys': np.array([0, 2, 5]), 'high_res': hr, 'cam': hr[:, ::4, ::4]}
    with pytest.raises(ValueError, match='intractable'):
        jirnet.cam_to_ir_label(img, d, 'ADP-morph', conf_fg_thres=0.5)
    with pytest.raises(ValueError, match='intractable'):
        irnet.cam_to_ir_label(img, d, 'ADP-morph', conf_fg_thres=0.5,
                              device='cpu')
