"""The port's IRNet (three trunks), ResNet50 CAM net, edge/displacement
inference and trunk transplant against the JAX package's, with the flax
variables carried across by ``io.flax_bridge``.

Tolerances: edge logits, displacements, CAM logits and maps within 1e-4
of flax's (measured ~1e-6 to 1e-5); the bridge's round trip is exact;
transplanted trunk activations within 1e-5 of the classifier's, as the
reference's own test holds them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import perturbed_variables
from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu.models import irn as jirn
from wsss_tpu.models.resnet50 import ResNet50CAM as JResNet50CAM
from wsss_tpu.models.transplant import \
    transplant_classifier_trunk as jax_transplant
from wsss_tpu_torch.io.flax_bridge import (irnet_variables,
                                           load_flax_irnet,
                                           load_flax_variables)
from wsss_tpu_torch.models import irn
from wsss_tpu_torch.models.backbones import build_classifier
from wsss_tpu_torch.models.resnet50 import ResNet50CAM
from wsss_tpu_torch.models.transplant import transplant_classifier_trunk

TOL = 1e-4


def _perturbed(model, size, seed):
    """flax variables (numpy leaves) of ``model``: default init, every
    bias, norm scale and statistic perturbed so each map of the bridge
    carries a distinct value."""
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.array(a, np.float32)
        name = jax.tree_util.keystr(path)
        if 'kernel' in name:
            return a
        if "'var'" in name:
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(perturb, variables)


def _close(name, got, want):
    d = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    print(f'{name}: max |diff| {d:.3e} (max |value| '
          f'{float(np.abs(np.asarray(want)).max()):.4g})')
    assert np.asarray(got).shape == np.asarray(want).shape
    assert d <= TOL


def _same_tree(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize('backbone,size', [('vgg16', 48), ('m7', 40),
                                           ('resnet50', 64)])
def test_irnet_matches_flax(backbone, size):
    model = jirn.IRNet(backbone=backbone)
    variables = _perturbed(model, size, seed=2)
    x = np.random.default_rng(0).normal(0, 1, (2, size, size, 3)
                                        ).astype(np.float32)
    e_j, d_j = jax.jit(model.apply)(variables, jnp.asarray(x))
    net = load_flax_irnet(irn.IRNet(backbone), variables)
    e_t, d_t = net(torch.from_numpy(x))
    _close(f'{backbone} edge logits', e_t.detach().numpy(), e_j)
    _close(f'{backbone} displacement', d_t.detach().numpy(), d_j)
    _same_tree(irnet_variables(net), variables)
    # the trunk stays frozen and in eval mode whatever the heads do
    net.train()
    assert net.fc_dp1.training and not net.trunk.training


def test_irnet_trunk_takes_no_gradient():
    net = irn.IRNet('m7')
    edge, disp = net(torch.rand(1, 32, 32, 3))
    (edge.sum() + disp.sum()).backward()
    assert all(p.grad is None for p in net.trunk.parameters())
    assert all(p.grad is not None for p in net.fc_edge1.parameters())


def test_resnet50_cam_matches_flax():
    model = JResNet50CAM(5)
    variables = _perturbed(model, 64, seed=3)
    x = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 3)
                                        ).astype(np.float32)
    logits_j = jax.jit(model.apply)(variables, jnp.asarray(x))
    cam_j = jax.jit(lambda v, x: model.apply(v, x, method=model.cam))(
        variables, jnp.asarray(x))
    net = load_flax_irnet(ResNet50CAM(5), variables)
    with torch.no_grad():
        _close('ResNet50CAM logits', net(torch.from_numpy(x)).numpy(),
               logits_j)
        _close('ResNet50CAM cam', net.cam(torch.from_numpy(x)).numpy(),
               cam_j)
    _same_tree(irnet_variables(net), variables)


@pytest.mark.parametrize('shift', [True, False])
def test_edge_displacement_inference_matches_jax(shift):
    """m7: edge at /2, displacement at /4 (tests/test_irnet.py:126-135),
    flip-merged, and mean-shifted when a ``disp_mean`` is given, as the
    reference does."""
    model = jirn.IRNet(backbone='m7')
    variables = _perturbed(model, 32, seed=4)
    img = np.random.default_rng(2).normal(0, 1, (1, 32, 32, 3)
                                          ).astype(np.float32)
    disp_mean = np.array([0.25, -0.5], np.float32) if shift else None
    e_j, d_j = jirn.edge_displacement_inference(
        jax.jit(model.apply), variables, jnp.asarray(img), disp_mean)
    net = load_flax_irnet(irn.IRNet('m7'), variables)
    e_t, d_t = irn.edge_displacement_inference(
        net, torch.from_numpy(img), disp_mean)
    assert tuple(e_t.shape) == (16, 16) and tuple(d_t.shape) == (8, 8, 2)
    _close('merged edge', e_t.numpy(), e_j)
    _close('shifted displacement' if shift else 'displacement',
           d_t.numpy(), d_j)


def _trunk_feats(net, x):
    with torch.no_grad():
        return net.trunk(torch.from_numpy(x).permute(0, 3, 1, 2))


@pytest.mark.parametrize('backbone,model_type,size',
                         [('vgg16', 'VGG16', 32), ('m7', 'M7', 32)])
def test_trunk_activations_match_classifier(backbone, model_type, size):
    """The transplanted trunk computes the classifier's features (the
    reference's tests/test_transplant.py), and the transplanted IRNet
    equals the JAX package's transplanted IRNet."""
    _, clf_vars = perturbed_variables(model_type, 5, size, seed=3)
    clf = load_flax_variables(build_classifier(model_type, 5), clf_vars)
    clf.eval()
    model = jirn.IRNet(backbone=backbone)
    net_vars = _perturbed(model, size, seed=0)
    net = load_flax_irnet(irn.IRNet(backbone), net_vars)
    before = [p.clone() for p in net.trunk.parameters()]
    assert transplant_classifier_trunk(clf, net, backbone) is net
    assert any(not torch.equal(a, b)
               for a, b in zip(before, net.trunk.parameters()))
    x = np.random.default_rng(0).uniform(0, 1, (1, size, size, 3)
                                         ).astype(np.float32)
    feats = _trunk_feats(net, x)
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        if backbone == 'vgg16':
            ref = clf.backbone(xc)
            for f, r in zip(feats, ref):
                np.testing.assert_allclose(f.numpy(), r.numpy(), atol=1e-5)
        else:
            s2 = clf.layer2(clf.layer1(xc))
            np.testing.assert_allclose(feats[1].numpy(), s2.numpy(),
                                       atol=1e-5)
            pooled = torch.nn.functional.max_pool2d(clf.layer3_p1(s2), 2, 2)
            np.testing.assert_allclose(feats[2].numpy(), pooled.numpy(),
                                       atol=1e-5)
    want_vars = jax_transplant(clf_vars, net_vars, backbone)
    _same_tree(irnet_variables(net), want_vars)
    e_j, d_j = jax.jit(model.apply)(want_vars, jnp.asarray(x))
    e_t, d_t = net(torch.from_numpy(x))
    _close(f'transplanted {backbone} edge', e_t.detach().numpy(), e_j)
    _close(f'transplanted {backbone} disp', d_t.detach().numpy(), d_j)


def test_shape_mismatch_rejected():
    with pytest.raises(ValueError):
        transplant_classifier_trunk(build_classifier('VGG16', 5),
                                    irn.IRNet('m7'), 'm7')
    with pytest.raises(ValueError, match='structure mismatch'):
        transplant_classifier_trunk(build_classifier('VGG16fg', 5),
                                    irn.IRNet('vgg16'), 'vgg16')
    with pytest.raises(ValueError, match='unknown backbone'):
        transplant_classifier_trunk(build_classifier('VGG16', 5),
                                    irn.IRNet('resnet50'), 'resnet50')
