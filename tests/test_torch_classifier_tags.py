"""The port's remaining classifier tags (VGG16fg, VGG16fg_bn, M1-M6), its
bf16 inference opt-in and the model triplet, against the JAX package.

Tolerances.  Float32, flax variables carried across by io/flax_bridge:
scores within 1e-5, feats within 1e-4 of their largest magnitude
(different convolution algorithms).  bfloat16 (WSSS_TPU_BF16_INFER=1 in
both packages): each side rounds every conv, BN and head output to bf16
in its own accumulation order, so the limits are set from the observed
error, about 3x on the scores and the features' largest error, and
closer on the features' rms error and the share of features that differ,
which tell flax's float32-inside BatchNorm from a bf16 one; the pass
mask is equal at thresholds no score comes near."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import perturbed_variables
from wsss_tpu.io import checkpoint as jax_ckpt
from wsss_tpu.io import legacy as jax_legacy
from wsss_tpu.models import build_classifier as jax_build
from wsss_tpu.models import infer_dtype as jax_infer_dtype
from wsss_tpu_torch.io import checkpoint
from wsss_tpu_torch.io.flax_bridge import (classifier_params,
                                           classifier_variables,
                                           load_flax_variables)
from wsss_tpu_torch.models.backbones import build_classifier, infer_dtype

TAGS = [('VGG16fg', 32), ('VGG16fg_bn', 32), ('M1', 32), ('M2', 32),
        ('M3', 32), ('M4', 32), ('M5', 32), ('M6', 32)]


def _images(size, n=2, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


def _jax_forward(model, variables, x):
    s, f = jax.jit(model.apply)(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    return np.asarray(s.astype(jnp.float32)), np.asarray(
        f.astype(jnp.float32)), f.dtype


def _torch_forward(net, x):
    with torch.no_grad():
        s, f = net.eval()(torch.from_numpy(x))
    return s.numpy(), f.to(torch.float32).numpy(), f.dtype


def _close(got, want, s_tol, f_tol):
    (s_t, f_t), (s_j, f_j) = got, want
    assert s_t.shape == s_j.shape and f_t.shape == f_j.shape
    np.testing.assert_allclose(s_t, s_j, atol=s_tol)
    np.testing.assert_allclose(f_t, f_j, atol=f_tol * np.abs(f_j).max())


@pytest.mark.parametrize('tag,size', TAGS)
def test_tag_matches_flax(tag, size):
    model, variables = perturbed_variables(tag, 7, size, seed=3)
    assert ('batch_stats' in variables) == (tag != 'VGG16fg')
    net = load_flax_variables(build_classifier(tag, 7), variables)
    x = _images(size)
    s_j, f_j, _ = _jax_forward(model, variables, x)
    s_t, f_t, _ = _torch_forward(net, x)
    _close((s_t, f_t), (s_j, f_j), 1e-5, 1e-4)
    # the inverse map gives back the flax params exactly
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            variables['params'])[0]:
        node = classifier_params(net)
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def _separating_thresholds(scores):
    """Per class, the middle of the widest gap between 0, 1 and the
    class's scores: no score lies within a sixth of it (batch 2)."""
    th = []
    for col in scores.T:
        v = np.sort(np.concatenate([[0.0, 1.0], col]))
        k = int(np.argmax(np.diff(v)))
        th.append((v[k] + v[k + 1]) / 2)
    return np.asarray(th, np.float32)


# observed (score, feat-max, feat-rms, feat-share) errors at these inputs:
# M7 1.31e-3, 8.8e-3, 5.66e-3, 0.31; VGG16fg_bn 3.57e-4, 6.9e-3, 3.22e-3,
# 0.23.  A BatchNorm that ran in bf16 throughout (rounding after each of
# its steps) exceeds the rms and share limits on both tags.
@pytest.mark.parametrize('tag,size,s_tol,f_tol,f_rms', [
    ('M7', 48, 4e-3, 2.7e-2, 7.5e-3),
    ('VGG16fg_bn', 32, 1.1e-3, 2.1e-2, 4.5e-3)])
def test_bf16_forward_matches_flax(monkeypatch, tag, size, s_tol, f_tol,
                                   f_rms):
    monkeypatch.setenv('WSSS_TPU_BF16_INFER', '1')
    monkeypatch.delenv('WSSS_TPU_NO_BF16_INFER', raising=False)
    _, variables = perturbed_variables(tag, 9, size, seed=5)
    model = jax_build(tag, 9)                  # bf16 from the variable
    assert model.dtype == jnp.bfloat16
    net = load_flax_variables(build_classifier(tag, 9), variables)
    assert net.dtype == torch.bfloat16
    assert net.head.weight.dtype == torch.float32     # params stay f32
    x = _images(size)
    s_j, f_j, fdt_j = _jax_forward(model, variables, x)
    s_t, f_t, fdt_t = _torch_forward(net, x)
    assert fdt_j == jnp.bfloat16 and fdt_t == torch.bfloat16
    d = f_t - f_j
    rms = np.sqrt(np.mean(d ** 2)) / np.sqrt(np.mean(f_j ** 2))
    share = float(np.mean(d != 0))
    print(f'bf16 {tag}: max |d score| {np.abs(s_t - s_j).max():.3e}, '
          f'max |d feat| {np.abs(d).max() / np.abs(f_j).max():.3e} of the '
          f'max, rms {rms:.3e}, share {share:.3f}')
    _close((s_t, f_t), (s_j, f_j), s_tol, f_tol)
    assert rms <= f_rms and share <= 0.45, (rms, share)
    th = _separating_thresholds(s_j)
    np.testing.assert_array_equal(s_t >= th, s_j >= th)
    # and bf16 is not f32: the opt-in changed the numbers
    monkeypatch.delenv('WSSS_TPU_BF16_INFER')
    s_f, _, _ = _torch_forward(load_flax_variables(
        build_classifier(tag, 9), variables), x)
    assert not np.array_equal(s_f, s_t)


@pytest.mark.parametrize('env,want', [
    ({}, 'float32'),
    ({'WSSS_TPU_BF16_INFER': '1'}, 'bfloat16'),
    ({'WSSS_TPU_NO_BF16_INFER': '1'}, 'float32'),
    ({'WSSS_TPU_BF16_INFER': '1', 'WSSS_TPU_NO_BF16_INFER': '1'},
     'float32'),
    ({'WSSS_TPU_BF16_INFER': ''}, 'float32')])
def test_infer_dtype_follows_both_variables(monkeypatch, env, want):
    for k in ('WSSS_TPU_BF16_INFER', 'WSSS_TPU_NO_BF16_INFER'):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert str(infer_dtype()).split('.')[-1] == want
    assert jnp.dtype(jax_infer_dtype()).name == want
    # build_classifier's own default reads WSSS_TPU_BF16_INFER only
    default = jnp.dtype(jax_build('M7', 3).dtype).name
    assert str(build_classifier('M7', 3).dtype).split('.')[-1] == default


def _jax_triplet_model(tag, n, size, model_dir, sid):
    """JAX's load_handle: init variables, then the triplet's params."""
    model = jax_build(tag, n)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, size, size, 3)))
    _, params, th = jax_ckpt.import_triplet(model_dir, sid,
                                            variables['params'])
    return model, dict(variables, params=params), th


@pytest.mark.parametrize('tag', ['M7', 'VGG16fg'])
def test_jax_triplet_loads_into_port(tmp_path, tag):
    size = 32
    model, variables = perturbed_variables(tag, 5, size, seed=6)
    th = np.array([0.0, 1.01, 0.25, 0.5, 0.75], np.float32)
    jax_ckpt.export_triplet(str(tmp_path), 'sid', {'arch': tag},
                            variables['params'], thresholds=th)
    jm, jv, jth = _jax_triplet_model(tag, 5, size, str(tmp_path), 'sid')
    net = build_classifier(tag, 5)
    # statistics of its own must not survive the load
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.fill_(3.0)
    arch, net, pth = checkpoint.import_triplet(str(tmp_path), 'sid', net)
    assert arch == {'arch': tag}
    np.testing.assert_array_equal(pth, th)
    np.testing.assert_array_equal(pth, jth)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert float(m.running_mean.abs().max()) == 0.0
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    x = _images(size)
    s_j, f_j, _ = _jax_forward(jm, jv, x)
    _close(_torch_forward(net, x)[:2], (s_j, f_j), 1e-5, 1e-4)


@pytest.mark.parametrize('tag', ['M7', 'M3'])
def test_port_triplet_loads_into_jax(tmp_path, tag):
    size = 32
    _, variables = perturbed_variables(tag, 4, size, seed=7)
    net = load_flax_variables(build_classifier(tag, 4), variables)
    th = np.array([0.0, 1.01, 0.3, 0.6], np.float32)
    checkpoint.export_triplet(str(tmp_path), 'sid', {'arch': tag}, net,
                              thresholds=th)
    # the Keras .h5 sibling, read by the JAX package's reader
    checkpoint.export_triplet(str(tmp_path / 'h5'), 'sid', {}, net,
                              variables=classifier_variables(net))
    want = jax.tree_util.tree_map(np.asarray, variables)
    got = jax_legacy.load_keras_weights_into(
        want, jax_legacy.read_keras_h5(str(tmp_path / 'h5' / 'sid.h5')))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    with pytest.raises(ValueError, match='has shape'):
        checkpoint.import_triplet(str(tmp_path), 'sid',
                                  build_classifier(tag, 5))
    jm, jv, jth = _jax_triplet_model(tag, 4, size, str(tmp_path), 'sid')
    np.testing.assert_array_equal(jth, th)
    _, back, _ = checkpoint.import_triplet(str(tmp_path), 'sid',
                                           build_classifier(tag, 4))
    x = _images(size)
    s_j, f_j, _ = _jax_forward(jm, jv, x)
    _close(_torch_forward(back, x)[:2], (s_j, f_j), 1e-5, 1e-4)
