"""The port's VGG16 / M7 classifiers, with the reference's flax weights
carried across by io/flax_bridge, against the flax models: scores and
feats agree within 1e-4 of their largest magnitude (f32, different
convolution algorithms)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsss_tpu.models import build_classifier as jax_build
from wsss_tpu_torch.io.flax_bridge import load_flax_variables
from wsss_tpu_torch.models.backbones import build_classifier


def perturbed_variables(model_type, num_classes, size, seed):
    """flax (model, numpy variables): default init, then every bias, BN
    scale and running statistic perturbed with numpy, so each mapping of
    the bridge carries a distinct value."""
    model = jax_build(model_type, num_classes)
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
    return model, jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.mark.parametrize('model_type,size', [('VGG16', 64), ('M7', 48)])
def test_bridged_classifier_matches_flax(model_type, size):
    model, variables = perturbed_variables(model_type, 20, size, seed=3)
    net = load_flax_variables(build_classifier(model_type, 20),
                              variables).eval()
    x = np.random.default_rng(0).uniform(-1, 1, (2, size, size, 3)
                                         ).astype(np.float32)
    s_j, f_j = jax.jit(model.apply)(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        s_t, f_t = net(torch.from_numpy(x))
    s_j, f_j = np.asarray(s_j), np.asarray(f_j)
    assert f_t.shape == f_j.shape and s_t.shape == s_j.shape
    np.testing.assert_allclose(f_t.numpy(), f_j,
                               atol=1e-4 * np.abs(f_j).max())
    np.testing.assert_allclose(s_t.numpy(), s_j, atol=1e-4)


def test_bridge_layout():
    """HWIO -> OIHW, Dense [in,out] -> [out,in], BN stats and eps."""
    model, variables = perturbed_variables('M7', 6, 32, seed=4)
    net = load_flax_variables(build_classifier('M7', 6), variables)
    k = variables['params']['layer2']['Conv_1']['kernel']
    np.testing.assert_array_equal(
        net.layer2.convs[1].weight.detach().numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(net.head.weight.detach().numpy(),
                                  variables['params']['head']['kernel'].T)
    bn = net.layer3_p1.bns[2]
    np.testing.assert_array_equal(
        bn.running_var.numpy(),
        variables['batch_stats']['layer3_p1']['BatchNorm_2']['var'])
    assert bn.eps == 1e-3
    with pytest.raises(KeyError):
        load_flax_variables(build_classifier('M7', 6),
                            {'params': {'layer1': {}}})


def test_random_init_is_seeded():
    from wsss_tpu_torch.models.backbones import init_random
    wa, wb, wc = (
        init_random(build_classifier('M7', 6),
                    torch.Generator().manual_seed(seed)
                    ).layer1.convs[0].weight.detach()
        for seed in (5, 5, 6))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    fan_in = 3 * 3 * 3
    assert abs(float(wa.std()) - (1 / fan_in) ** 0.5) < 0.1
