"""The port's DeepLab networks (SECNet, DSRGNet) against the JAX
package's flax modules on bridged weights: same numpy images, logits
within 1e-4 of the largest magnitude, at odd sizes (33, 65: 'SAME' pools
pad (1, 1)) and an even one (64: they pad (0, 1)); sp_softmax within
1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsss_tpu.models import deeplab as jax_deeplab
from wsss_tpu_torch.io.flax_bridge import load_flax_deeplab
from wsss_tpu_torch.models import deeplab
from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor

N_CLS = 5


def bridged_deeplab(method, n_cls, size, seed=0):
    """(jitted flax forward, numpy params, port predictor on the CPU)."""
    jnet = (jax_deeplab.SECNet if method == 'SEC'
            else jax_deeplab.DSRGNet)(num_classes=n_cls)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, size, size, 3)))['params']
    # flax biases start at zero: draw them too so the bridge is tested
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(l) if l.ndim > 1
              else rng.normal(0, 0.1, l.shape).astype(np.float32)
              for l in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    fwd = jax.jit(lambda x: jnet.apply({'params': params}, x, train=False))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return fwd, np_params, SECDSRGPredictor.from_flax(method, np_params,
                                                      device='cpu')


@pytest.mark.parametrize('method', ['SEC', 'DSRG'])
@pytest.mark.parametrize('size', [33, 65, 64])
def test_logits_match_flax(method, size):
    fwd, _, pred = bridged_deeplab(method, N_CLS, size)
    x = np.random.default_rng(size).normal(
        0, 50, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(fwd(jnp.asarray(x)))
    got = pred.predict_logits(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, (size - 1) // 8 + 1,
                                       (size - 1) // 8 + 1, N_CLS)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_same_padding_of_the_pools():
    assert deeplab._same_pad(321, 3, 2) == (1, 1)
    assert deeplab._same_pad(64, 3, 2) == (0, 1)
    assert deeplab._same_pad(41, 3, 1) == (1, 1)
    x = torch.arange(16.).view(1, 1, 4, 4) - 20.     # all negative
    got = deeplab.max_pool_same(x, 3, 2)
    assert got.shape == (1, 1, 2, 2)
    assert float(got.max()) < 0                      # -inf pad, not zero


def test_sp_softmax_and_random_predictor():
    logits = np.random.default_rng(1).normal(0, 3, (2, 5, 5, N_CLS)
                                             ).astype(np.float32)
    want = np.asarray(jax_deeplab.sp_softmax(jnp.asarray(logits)))
    got = deeplab.sp_softmax(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert deeplab.MIN_PROB == jax_deeplab.MIN_PROB
    a = SECDSRGPredictor.random('DSRG', 3, seed=4, device='cpu')
    b = SECDSRGPredictor('dsrg', 3, device='cpu', seed=4)
    x = torch.ones((1, 17, 17, 3))
    assert a.predict_logits(x).shape == (1, 3, 3, 3)
    assert torch.equal(a.predict_logits(x), b.predict_logits(x))
    assert not a.net.training
    with pytest.raises(ValueError):
        SECDSRGPredictor('IRN', 3, device='cpu')
    with pytest.raises(TypeError, match='no flax mapping'):
        load_flax_deeplab(torch.nn.Linear(1, 1), {})
