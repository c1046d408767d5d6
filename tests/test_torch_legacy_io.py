"""The port's legacy weight formats and training checkpoints against the
JAX package's (the cases of tests/test_io.py): Keras .h5 in both
directions with equal classifier outputs (scores within 1e-5, feats
within 1e-4 of their largest magnitude: two convolution libraries), the
slot order, the thresholds .mat, the DeepLab init .npy into SEC and DSRG
(weights equal to the JAX package's after the bridge), the torch.save
checkpoints in the step_{:08d} layout, the refusal of an orbax
checkpoint, and the triplet's .h5 sibling read by the JAX package."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_io import _keras_224_model_h5, _keras_style_h5
from test_torch_classifier_tags import (_close, _images, _jax_forward,
                                        _torch_forward)
from test_torch_deeplab import bridged_deeplab
from test_torch_models import perturbed_variables
from wsss_tpu.io import checkpoint as jax_ckpt
from wsss_tpu.io import legacy as jax_legacy
from wsss_tpu.models import build_classifier as jax_build
from wsss_tpu_torch.io import checkpoint, legacy
from wsss_tpu_torch.io.flax_bridge import (classifier_variables,
                                           deeplab_params, load_flax_deeplab,
                                           load_flax_variables)
from wsss_tpu_torch.models.backbones import build_classifier

SIZE = 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trees_equal(got, want):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


@pytest.mark.parametrize('tag', ['M7', 'VGG16fg'])
def test_keras_h5_written_by_jax_loads_into_port(tmp_path, tag):
    model, variables = perturbed_variables(tag, 5, SIZE, seed=11)
    path = str(tmp_path / 'jax.h5')
    jax_legacy.write_keras_h5(path, variables)
    weights = legacy.read_keras_h5(path)
    for a, b in zip(weights, jax_legacy.read_keras_h5(path)):
        np.testing.assert_array_equal(a, b)
    net = build_classifier(tag, 5)
    loaded = legacy.load_keras_weights_into(classifier_variables(net),
                                            weights)
    _trees_equal(loaded, _np(variables))
    load_flax_variables(net, loaded)
    x = _images(SIZE, seed=3)
    s_j, f_j, _ = _jax_forward(model, variables, x)
    _close(_torch_forward(net, x)[:2], (s_j, f_j), 1e-5, 1e-4)
    with pytest.raises(ValueError, match='count mismatch'):
        legacy.load_keras_weights_into(classifier_variables(net),
                                       weights[:-1])
    with pytest.raises(ValueError, match='shape mismatch'):
        legacy.load_keras_weights_into(
            classifier_variables(build_classifier(tag, 4)), weights)


@pytest.mark.parametrize('tag', ['M7', 'VGG16'])
def test_keras_h5_written_by_port_loads_into_jax(tmp_path, tag):
    _, variables = perturbed_variables(tag, 4, SIZE, seed=12)
    net = load_flax_variables(build_classifier(tag, 4), variables)
    path = str(tmp_path / 'port.h5')
    legacy.write_keras_h5(path, classifier_variables(net))
    model = jax_build(tag, 4)
    fresh = jax.jit(model.init)(jax.random.PRNGKey(5),
                                jnp.zeros((1, SIZE, SIZE, 3)))
    restored = jax_legacy.load_keras_weights_into(
        fresh, jax_legacy.read_keras_h5(path))
    _trees_equal(_np(restored), _np(variables))
    x = _images(SIZE, seed=4)
    s_j, f_j, _ = _jax_forward(model, restored, x)
    _close(_torch_forward(net, x)[:2], (s_j, f_j), 1e-5, 1e-4)
    assert legacy.keras_weight_groups(classifier_variables(net)) != []
    for (n, ws), (nj, wsj) in zip(
            legacy.keras_weight_groups(classifier_variables(net)),
            jax_legacy.keras_weight_groups(variables)):
        assert n == nj and [w for w, _ in ws] == [w for w, _ in wsj]


@pytest.mark.parametrize('tag', ['M7', 'VGG16'])
def test_slot_order_equals_jax(tag):
    """Conv_i before BatchNorm_i before Conv_{i+1}, the head last; the
    same slots and stat slots as the JAX package's."""
    _, variables = perturbed_variables(tag, 3, SIZE, seed=0)
    tree = _np(variables)
    names = ['/'.join(p) for p, _ in legacy._conv_bn_dense_slots(
        tree['params'])]
    want = ['/'.join(getattr(k, 'key', str(k)) for k in p)
            for p, _ in jax_legacy._conv_bn_dense_slots(variables['params'])]
    assert names == want
    stats = ['/'.join(p) for p, _ in legacy._bn_stat_slots(
        tree['batch_stats'])]
    assert stats == ['/'.join(getattr(k, 'key', str(k)) for k in p)
                     for p, _ in jax_legacy._bn_stat_slots(
                         variables['batch_stats'])]
    first = 'layer1' if tag == 'M7' else 'backbone/layer1'
    assert (names.index(f'{first}/Conv_0/kernel')
            < names.index(f'{first}/BatchNorm_0/scale')
            < names.index(f'{first}/Conv_1/kernel'))
    assert names[-2:] == ['head/kernel', 'head/bias']


def test_keras_files_of_the_reference_layout(tmp_path):
    """A byte-faithful Keras 2.2.4 model.save() file (nested
    model_weights, weightless layers, two-digit names) and a flat
    save_weights file read alike in both packages."""
    net = build_classifier('VGG16', 4)
    variables = classifier_variables(net)
    slots = legacy._conv_bn_dense_slots(variables['params'])
    stats = legacy._bn_stat_slots(variables['batch_stats'])
    rng = np.random.default_rng(0)
    layers, si, i = [], 0, 0
    while i < len(slots):
        path, leaf = slots[i]
        if path[-1] == 'scale':
            vals = [rng.normal(size=np.shape(l)).astype(np.float32)
                    for _, l in (slots[i], slots[i + 1], stats[si],
                                 stats[si + 1])]
            layers.append((f'batch_normalization_{si // 2 + 1}',
                           list(zip(('gamma', 'beta', 'moving_mean',
                                     'moving_variance'), vals))))
            layers.append((f'activation_{si // 2 + 1}', []))
            si += 2
        else:
            layers.append((f'conv2d_{i}' if np.ndim(leaf) == 4
                           else 'dense_1',
                           [(n, rng.normal(size=np.shape(l)).astype(
                               np.float32))
                            for n, (_, l) in zip(('kernel', 'bias'),
                                                 slots[i:i + 2])]))
        i += 2
    path = _keras_224_model_h5(str(tmp_path / 'model.h5'), layers)
    weights = legacy.read_keras_h5(path)
    want = jax_legacy.read_keras_h5(path)
    assert len(weights) == len(want) > 40
    for a, b in zip(weights, want):
        np.testing.assert_array_equal(a, b)
    loaded = legacy.load_keras_weights_into(variables, weights)
    np.testing.assert_array_equal(
        loaded['batch_stats']['backbone']['layer1']['BatchNorm_0']['mean'],
        weights[4])
    flat = _keras_style_h5(tmp_path, weights[:3])
    for a, b in zip(legacy.read_keras_h5(flat),
                    jax_legacy.read_keras_h5(flat)):
        np.testing.assert_array_equal(a, b)


def test_thresholds_mat_equals_jax(tmp_path):
    import scipy.io as sio
    p = str(tmp_path / 't.mat')
    sio.savemat(p, {'optimalScoreThresh': np.array([[0.1, 0.5, 0.9, 0.2]])})
    for path, n in ((p, 3), (p, 4), (str(tmp_path / 'missing.mat'), 3)):
        got = legacy.load_thresholds_mat(path, n)
        want = jax_legacy.load_thresholds_mat(path, n)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(legacy.load_thresholds_mat(p, 3),
                               [1 / 3, 0.5, 0.9])


def _init_npy(path, np_params, method, rng):
    """The reference's init.npy layout: layer -> {'w', 'b'}; DSRG heads
    as fc{n}_{k}, plus a layer no model has."""
    init = {name: {'w': rng.normal(size=p['kernel'].shape).astype(np.float32),
                   'b': rng.normal(size=p['bias'].shape).astype(np.float32)}
            for name, p in np_params['trunk'].items()}
    heads = ([('head', '')] if method == 'SEC' else
             [(f'branch{r}', f'_{k}') for k, r in
              enumerate((6, 12, 18, 24), start=1)])
    for key, suffix in heads:
        for n in ('6', '7', '8'):
            p = np_params[key][f'fc{n}']
            init[f'fc{n}{suffix}'] = {
                'w': rng.normal(size=p['kernel'].shape).astype(np.float32),
                'b': rng.normal(size=p['bias'].shape).astype(np.float32)}
    init['pool9'] = {'w': np.zeros(1), 'b': np.zeros(1)}
    np.save(path, init, allow_pickle=True)
    return init


@pytest.mark.parametrize('method', ['SEC', 'DSRG'])
def test_deeplab_init_npy_equals_jax(tmp_path, method):
    _, np_params, pred = bridged_deeplab(method, 4, 33, seed=2)
    path = str(tmp_path / 'init.npy')
    init = _init_npy(path, np_params, method, np.random.default_rng(3))
    for skip_final in (True, False):
        want = _np(jax_legacy.load_deeplab_init_npy(
            path, jax.tree_util.tree_map(jnp.asarray, np_params),
            skip_final=skip_final))
        before = deeplab_params(pred.net)
        got = legacy.load_deeplab_init_npy(path, before,
                                           skip_final=skip_final)
        _trees_equal(before, deeplab_params(pred.net))   # input untouched
        load_flax_deeplab(pred.net, got)
        _trees_equal(deeplab_params(pred.net), want)
        head = 'head' if method == 'SEC' else 'branch6'
        suffix = '' if method == 'SEC' else '_1'
        np.testing.assert_array_equal(want['trunk']['conv3_2']['kernel'],
                                      init['conv3_2']['w'])
        assert skip_final == (not np.array_equal(
            want[head]['fc8']['bias'], init['fc8' + suffix]['b']))
        load_flax_deeplab(pred.net, np_params)
    bad = {'conv1_1': {'w': np.zeros((1, 1, 3, 64)), 'b': np.zeros(64)}}
    np.save(path, bad, allow_pickle=True)
    with pytest.raises(ValueError, match='kernel shape'):
        legacy.load_deeplab_init_npy(path, deeplab_params(pred.net))
    np.save(path, {'pool9': {'w': 0, 'b': 0}}, allow_pickle=True)
    with pytest.raises(ValueError, match='no layers'):
        legacy.load_deeplab_init_npy(path, deeplab_params(pred.net))


def test_checkpoint_round_trip_and_latest_step(tmp_path):
    root = str(tmp_path / 'run')
    assert checkpoint.latest_step(root) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(root)
    net = build_classifier('M7', 3)
    state = {'params': net.state_dict(), 'step': 7}
    path = checkpoint.save_checkpoint(root, 7, state)
    assert path == os.path.abspath(os.path.join(root, 'step_00000007'))
    checkpoint.save_checkpoint(root, 12, {'params': {'w': torch.ones(2)}})
    # the layout the JAX package's latest-step discovery reads
    assert checkpoint.latest_step(root) == jax_ckpt.latest_step(root) == 12
    back, step = checkpoint.restore_checkpoint(root, step=7)
    assert step == 7 and back['step'] == 7
    for k, v in net.state_dict().items():
        assert torch.equal(back['params'][k], v), k
    back, step = checkpoint.restore_checkpoint(root)
    assert step == 12 and torch.equal(back['params']['w'], torch.ones(2))
    assert sorted(os.listdir(path)) == [checkpoint.STATE_FILE]


def test_orbax_checkpoint_is_refused(tmp_path):
    """A checkpoint the JAX package wrote with orbax is found as the
    latest step, and restoring it raises instead of guessing."""
    root = str(tmp_path / 'run')
    checkpoint.save_checkpoint(root, 3, {'params': {'w': torch.ones(2)}})
    jax_ckpt.save_checkpoint(root, 5, {'params': {'w': jnp.ones(2)}})
    assert checkpoint.latest_step(root) == 5
    with pytest.raises(ValueError, match='orbax'):
        checkpoint.restore_checkpoint(root)
    assert checkpoint.restore_checkpoint(root, step=3)[1] == 3


def test_export_triplet_h5_reads_in_jax(tmp_path):
    _, variables = perturbed_variables('M7', 3, SIZE, seed=13)
    net = load_flax_variables(build_classifier('M7', 3), variables)
    th = np.array([0.2, 0.4, 0.6], np.float32)
    checkpoint.export_triplet(str(tmp_path), 'sess', {'model': 'M7'}, net,
                              th, variables=classifier_variables(net))
    assert sorted(os.listdir(tmp_path)) == ['sess.h5', 'sess.json',
                                            'sess.mat', 'sess.npz']
    restored = jax_legacy.load_keras_weights_into(
        variables, jax_legacy.read_keras_h5(str(tmp_path / 'sess.h5')))
    _trees_equal(_np(restored), _np(variables))
    _, params, th_j = jax_ckpt.import_triplet(str(tmp_path), 'sess',
                                              variables['params'])
    _trees_equal(_np(params), _np(variables['params']))
    np.testing.assert_array_equal(th_j, th)
