"""The port's IRNet trainer (``wsss_tpu_torch/methods/irnet.py:
IRNTrainer``) against the JAX package's on the same numpy inputs, from
the same flax initial variables carried across by the bridge.

Geometry: crop 32 (the /4 grid is 8x8), radius 3, batch 1-2, max_step 4,
so that four steps walk the whole poly schedule, the x10 on the ``fc_dp*``
group and the weight decay on the GroupNorm and bias parameters all move
the heads.  Tolerances: each loss part and the total within 1e-4 (of
max(1, |value|)), head parameters within 5e-4, the trunk bit-equal to
its start; the optimizer alone (no network) within 1e-6 of optax's
chain."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu.methods import irnet as jirnet
from wsss_tpu.models import build_classifier as jax_build
from wsss_tpu.models.transplant import \
    transplant_classifier_trunk as jax_transplant
from wsss_tpu_torch.io.flax_bridge import (irnet_variables, load_flax_irnet,
                                           load_flax_variables)
from wsss_tpu_torch.methods import irnet
from wsss_tpu_torch.models.backbones import build_classifier
from wsss_tpu_torch.models.transplant import transplant_classifier_trunk

CROP, RADIUS, STEPS = 32, 3, 4
LOSS_TOL = 1e-4
PARAM_TOL = 5e-4
OPT_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _init_variables(backbone):
    """The JAX trainer's initial variables (key 0) as numpy, compiled
    once for every test of the backbone (they read them only)."""
    variables, _ = jirnet.IRNTrainer(backbone, 21, CROP).init(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, variables)


def _trainers(backbone, n_cls, max_step=STEPS):
    """(JAX trainer, its numpy init variables, port trainer on the CPU
    holding the same variables); both decay by the port's
    ``WEIGHT_DECAY``."""
    jt = jirnet.IRNTrainer(backbone, n_cls, CROP, radius=RADIUS,
                           weight_decay=irnet.WEIGHT_DECAY,
                           max_step=max_step)
    variables = _init_variables(backbone)
    pt = irnet.IRNTrainer(backbone, CROP, radius=RADIUS, max_step=max_step,
                          device='cpu')
    load_flax_irnet(pt.net, variables)
    return jt, variables, pt


def _batches(pidx, n_cls, b, n, seed):
    """n (images [b,32,32,3], bg_pos, fg_pos, neg [b,P,M]) from ir-label
    maps on the /4 grid with background, two classes and ignored cells."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        imgs = rng.normal(0, 1, (b, CROP, CROP, 3)).astype(np.float32)
        lab = rng.choice([0, 1, 2, 255], (b, CROP // 4, CROP // 4),
                         p=[0.4, 0.25, 0.25, 0.1]).astype(np.int64)
        packs = [irnet.affinity_labels(x, pidx, n_cls) for x in lab]
        out.append((imgs,) + tuple(np.stack(z) for z in zip(*packs)))
    return out


def _heads(tree):
    return {k: v for k, v in tree.items() if k != 'trunk'}


def _max_diff(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for (_, x), (_, y) in zip(fa, fb))


@pytest.mark.parametrize('backbone,batch', [('m7', 2), ('vgg16', 2),
                                            ('resnet50', 1)])
def test_four_steps_equal_jax(backbone, batch):
    jt, variables, pt = _trainers(backbone, 21)
    trunk0 = {k: v.clone() for k, v in pt.net.trunk.state_dict().items()}
    data = _batches(pt.path_index, 21, batch, 2, seed=3)
    step = jt.jitted_step()
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    opt = jt.tx.init(jv['params'])
    for i in range(STEPS):
        imgs, bg, fg, ng = data[i % 2]
        jv, opt, jparts = step(jv, opt, jnp.asarray(imgs), jnp.asarray(bg),
                               jnp.asarray(fg), jnp.asarray(ng))
        parts = pt.train_step(torch.from_numpy(imgs), bg, fg, ng)
        assert sorted(parts) == sorted(jparts)
        for k, want in jparts.items():
            got, want = float(parts[k]), float(want)
            print(f'{backbone} step {i} {k}: port {got:.6f} JAX {want:.6f}')
            assert abs(got - want) <= LOSS_TOL * max(1.0, abs(want))
    got = irnet_variables(pt.net)['params']
    want = jax.tree_util.tree_map(np.asarray, jv['params'])
    d = _max_diff(_heads(got), _heads(want))
    moved = _max_diff(_heads(want), _heads(variables['params']))
    print(f'{backbone}: heads max |diff| {d:.3e}, moved {moved:.3e}')
    assert d <= PARAM_TOL and moved > 10 * PARAM_TOL
    for k, v in pt.net.trunk.state_dict().items():
        assert torch.equal(v, trunk0[k]), k


def test_optimizer_equals_optax_chain(monkeypatch):
    """The two SGD groups against optax's chain on the same parameters
    and gradients, three updates: decay on every head parameter (the
    GroupNorm scales and biases and the conv biases too; a decay of 0.5
    makes it ~5e-3 of a parameter an update, far above the tolerance),
    x10 on fc_dp*, the poly schedule at the count before the update, the
    trunk still."""
    monkeypatch.setattr(irnet, 'WEIGHT_DECAY', 0.5)
    jt, variables, pt = _trainers('m7', 21, max_step=3)
    rng = np.random.default_rng(4)
    grads = [{n: rng.normal(0, 1, p.shape).astype(np.float32)
              for n, p in pt.net.named_parameters()} for _ in range(3)]
    twin = irnet.IRNet('m7')
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    opt = jt.tx.init(params)
    for g in grads:
        for n, p in pt.net.named_parameters():
            p.grad = torch.from_numpy(g[n])
        pt.tx.step()
        with torch.no_grad():
            for n, p in twin.named_parameters():
                p.copy_(torch.from_numpy(g[n]))
        jg = jax.tree_util.tree_map(jnp.asarray,
                                    irnet_variables(twin)['params'])
        updates, opt = jt.tx.update(jg, opt, params)
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
    got = irnet_variables(pt.net)['params']
    want = jax.tree_util.tree_map(np.asarray, params)
    d = _max_diff(got, want)
    print(f'optimizer: max |diff| {d:.3e} after 3 updates')
    assert d <= OPT_TOL
    assert _max_diff(got['trunk'], variables['params']['trunk']) == 0.0


def test_pair_displacement_equals_jax():
    jt, _, pt = _trainers('vgg16', 21)
    disp = np.random.default_rng(5).normal(
        0, 1, (2, CROP // 4, CROP // 4, 2)).astype(np.float32)
    want = np.asarray(jt._pair_displacement(jnp.asarray(disp)))
    got = pt._pair_displacement(torch.from_numpy(disp)).numpy()
    assert got.shape == want.shape == (2, 2) + (
        len(pt.path_index.search_dst), np.prod(pt.crop_hw))
    np.testing.assert_array_equal(got, want)


def test_calibrate_disp_mean_matches_bruteforce():
    """Full-split calibration is the mean of per-batch channel means over
    all batches (train_irn.py:156-164); and the JAX trainer's on the same
    variables within 1e-5."""
    jt, variables, pt = _trainers('m7', 21, max_step=10)
    rng = np.random.default_rng(6)
    batches = [rng.normal(0, 1, (2, CROP, CROP, 3)).astype(np.float32)
               for _ in range(3)]
    mean = pt.calibrate_disp_mean(iter(batches))
    with torch.no_grad():
        per_batch = [pt.net(torch.from_numpy(x))[1].numpy().mean(
            axis=(0, 1, 2)) for x in batches]
    ref = np.mean(np.stack(per_batch), axis=0)
    assert mean.shape == (2,) and mean.dtype == np.float32
    np.testing.assert_allclose(mean, ref, rtol=1e-6)
    want = jt.calibrate_disp_mean(variables, iter(batches))
    np.testing.assert_allclose(mean, want, atol=1e-5)


def test_irn_trainer_step_and_calibration():
    """tests/test_irnet.py::test_irn_trainer_step_and_calibration on the
    port: the loss falls over 4 steps, the trunk stays frozen."""
    tr = irnet.IRNTrainer('m7', crop_size=32, radius=3, max_step=10,
                          device='cpu')
    tr.init(torch.Generator().manual_seed(0))
    trunk0 = {k: v.clone() for k, v in tr.net.trunk.state_dict().items()}
    rng = np.random.default_rng(3)
    imgs = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    lab = rng.integers(0, 2, (2, 8, 8)).astype(np.int64)
    packs = [irnet.affinity_labels(x, tr.path_index, 21) for x in lab]
    bg, fg, ng = (np.stack(z) for z in zip(*packs))
    losses = [float(tr.train_step(imgs, bg, fg, ng)['total'])
              for _ in range(4)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    mean = tr.calibrate_disp_mean([imgs])
    assert mean.shape == (2,)
    for k, v in tr.net.trunk.state_dict().items():
        assert torch.equal(v, trunk0[k]), k


def test_irn_trainer_resnet50_smoke():
    """tests/test_irnet.py::test_irn_trainer_resnet50_smoke on the port:
    one step gives finite losses, edge and disp on the /4 grid, a frozen
    trunk."""
    tr = irnet.IRNTrainer('resnet50', crop_size=32, radius=3,
                          max_step=4, device='cpu')
    tr.init(torch.Generator().manual_seed(0))
    trunk0 = {k: v.clone() for k, v in tr.net.trunk.state_dict().items()}
    rng = np.random.default_rng(5)
    imgs = rng.normal(0, 1, (1, 32, 32, 3)).astype(np.float32)
    lab = rng.integers(0, 2, (1, 8, 8)).astype(np.int64)
    packs = [irnet.affinity_labels(x, tr.path_index, 4) for x in lab]
    bg, fg, ng = (np.stack(z) for z in zip(*packs))
    parts = tr.train_step(imgs, bg, fg, ng)
    assert np.isfinite(float(parts['total']))
    with torch.no_grad():
        edge, disp = tr.net(torch.from_numpy(imgs))
    assert edge.shape == (1, 8, 8, 1)
    assert disp.shape == (1, 8, 8, 2)
    for k, v in tr.net.trunk.state_dict().items():
        assert torch.equal(v, trunk0[k]), k


def test_irn_training_keeps_transplanted_trunk_frozen():
    """tests/test_transplant.py::test_irn_training_keeps_transplanted_
    trunk_frozen on the port: transplant a VGG16 classifier's trunk, one
    step, the trunk equals the classifier's bit for bit; the JAX
    package's transplant of the same classifier gives the same trunk."""
    model = jax_build('VGG16', 5)
    clf_vars = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    clf = load_flax_variables(build_classifier('VGG16', 5), clf_vars)
    jt, variables, tr = _trainers('vgg16', 6)
    transplant_classifier_trunk(clf, tr.net, 'vgg16')
    want = jax_transplant(clf_vars, variables, 'vgg16')
    assert _max_diff(irnet_variables(tr.net)['params']['trunk'],
                     want['params']['trunk']) == 0.0
    before = {k: v.clone() for k, v in tr.net.trunk.state_dict().items()}
    bg, fg, ng = irnet.affinity_labels(np.zeros((8, 8), np.int64),
                                       tr.path_index, 6)
    imgs = np.random.default_rng(0).normal(
        0, 1, (1, 32, 32, 3)).astype(np.float32)
    parts = tr.train_step(imgs, bg[None], fg[None], ng[None])
    assert np.isfinite(float(parts['total']))
    for k, v in tr.net.trunk.state_dict().items():
        assert torch.equal(v, before[k]), k
