"""The port's SEC / DSRG training (03a) against the JAX package's: the
losses, the CRF layer, the optimizer and one train step, on the same
seeded inputs and bridged weights, with flax's dropout masks replayed.

Tolerances: the losses and their gradients with respect to the logits
within 1e-5; the CRF layer's log-probabilities within 1e-4; the
optimizer's parameters within 1e-6 (float32 roundings of the multiplied
step); one train step's losses and updated parameters within 1e-4
(absolute and relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sec_dsrg import CFG, _toy
from test_torch_deeplab import bridged_deeplab
from test_torch_schedules import _torch_steps
from test_torch_train_classifier import (  # noqa: F401
    ReplayDropout, _dropout_masks, two_torch_threads)
from wsss_tpu.methods import dsrg as jax_dsrg
from wsss_tpu.methods import sec as jax_sec
from wsss_tpu.models.deeplab import sp_softmax as jax_sp_softmax
from wsss_tpu.train import sec_dsrg as jax_train
from wsss_tpu_torch.io.flax_bridge import deeplab_params, load_flax_deeplab
from wsss_tpu_torch.methods import dsrg, sec
from wsss_tpu_torch.models import backbones
from wsss_tpu_torch.models.deeplab import DSRGNet, SECNet, sp_softmax
from wsss_tpu_torch.ops.crf.config import CRFConfig
from wsss_tpu_torch.train import sec_dsrg

PORT_CFG = CRFConfig(*CFG.astuple())


def _t(a):
    return torch.from_numpy(np.array(a))


def _ties(logits):
    """The toy logits with equal rows at two pixels of each image, where
    absent class 2 takes its maximum: expand_loss's max splits its
    gradient between them (jnp.max; torch.max(dim=) would give it to one)
    and its sorts meet ties."""
    lg = np.array(logits)
    lg[:, 4, 4, 2] = lg[:, 6, 1, 2] = 9.0
    lg[:, 4, 4, 1:2] = lg[:, 6, 1, 1:2] = 0.0
    lg[:, 4, 4, 3] = lg[:, 6, 1, 3] = 0.0
    lg[:, 4, 4, 0] = lg[:, 6, 1, 0] = 0.0
    return jnp.asarray(lg)


LOSSES = {
    'seed': (lambda sm, c, l, i: sec.seed_loss(sm, c),
             lambda sm, c, l, i: jax_sec.seed_loss(sm, c)),
    'expand': (lambda sm, c, l, i: sec.expand_loss(sm, l),
               lambda sm, c, l, i: jax_sec.expand_loss(sm, l)),
    'balanced_seed': (lambda sm, c, l, i: dsrg.balanced_seed_loss(sm, c),
                      lambda sm, c, l, i: jax_dsrg.balanced_seed_loss(sm, c)),
    'constrain': (
        lambda sm, c, l, i: sec.constrain_loss(
            sm, torch.log(torch.softmax(i, -1))),
        lambda sm, c, l, i: jax_sec.constrain_loss(
            sm, jax.nn.log_softmax(i, -1))),
}


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('name', sorted(LOSSES))
def test_loss_and_gradient_equal_jax(name, ties):
    logits, cues, labels, _ = _toy()
    if ties:
        logits = _ties(logits)
    other = np.random.default_rng(5).normal(0, 1, logits.shape).astype(
        np.float32)
    ours, ref = LOSSES[name]
    lt = _t(logits).requires_grad_()
    got = ours(sp_softmax(lt), _t(cues), _t(labels), _t(other))
    got.backward()

    def f(lg):
        return ref(jax_sp_softmax(lg), cues, labels, jnp.asarray(other))
    want, grad = jax.value_and_grad(f)(logits)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(grad),
                               rtol=1e-5, atol=1e-6)


def test_crf_layer_equals_jax_and_carries_no_gradient():
    logits, _, _, imgs = _toy()
    imgs_seed = jax.image.resize(imgs, (2, 9, 9, 3), 'bilinear')
    want = jax_sec.crf_layer(jax_sp_softmax(logits), imgs_seed, CFG)
    lt = _t(logits).requires_grad_()
    got = sec.crf_layer(sp_softmax(lt), _t(imgs_seed), PORT_CFG)
    assert not got.requires_grad and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize('method', ['SEC', 'DSRG'])
def test_lr_multiplier_labels_equal_jax(method):
    """Every parameter's label from its port name equals the JAX label of
    its flax counterpart (found through the bridge by value)."""
    _, np_params, _ = bridged_deeplab(method, 3, 33, seed=0)
    jax_labels = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        jax_labels[jax.tree_util.keystr(path)] = (
            jax_train.lr_multiplier_label(path), np.asarray(leaf))
    net = (SECNet if method == 'SEC' else DSRGNet)(3)
    load_flax_deeplab(net, np_params)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(deeplab_params(net))[0]}
    seen = set()
    for name, p in net.named_parameters():
        value = p.detach().numpy()
        value = (value.transpose(2, 3, 1, 0) if value.ndim == 4 else value)
        key = next(k for k, v in flat.items()
                   if v.shape == value.shape and np.array_equal(v, value))
        assert sec_dsrg.lr_multiplier_label(name) == jax_labels[key][0], name
        seen.add(key)
    assert seen == set(jax_labels)
    finals = [n for n, _ in net.named_parameters()
              if sec_dsrg.lr_multiplier_label(n).startswith('final')]
    assert len(finals) == (2 if method == 'SEC' else 8)


@pytest.mark.parametrize('accum,calls', [(1, 3), (2, 4)])
def test_make_optimizer_equals_optax(accum, calls):
    """Per-group lr = base * multiplier and weight decay on the weights
    only, momentum without Nesterov, step decay every 2 updates: optax's
    chain on the same tree (with MultiSteps at accum 2)."""
    net = torch.nn.Module()
    net.trunk = torch.nn.Conv2d(2, 3, 3)
    net.head = torch.nn.ModuleDict({'fc7': torch.nn.Conv2d(3, 3, 1),
                                    'fc8': torch.nn.Conv2d(3, 2, 1)})
    names = [n for n, _ in net.named_parameters()]
    rng = np.random.default_rng(1)
    init = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    grads = [{n: rng.normal(0, 1, a.shape).astype(np.float32)
              for n, a in init.items()} for _ in range(calls)]
    opt = sec_dsrg.make_optimizer(net, base_lr=1e-2, steps_per_decay=2,
                                  accum_num=accum)
    got = _torch_steps(opt, list(net.parameters()),
                       [[g[n] for n in names] for g in grads])

    def nest(flat):
        """The flax-style tree of a port name -> array dict: the last key
        'kernel' or 'bias', 'fc8' among the keys where the name has it."""
        out = {}
        for n, v in flat.items():
            *head, leaf = n.split('.')
            node = out
            for k in head:
                node = node.setdefault(k, {})
            node['kernel' if leaf == 'weight' else 'bias'] = jnp.asarray(v)
        return out

    def unnest(tree):
        return [np.asarray(_at(tree, n)) for n in names]
    params = nest(init)
    tx = jax_train.make_optimizer(params, base_lr=1e-2, steps_per_decay=2,
                                  accum_num=accum)
    state = tx.init(params)
    for k, g in enumerate(grads):
        upd, state = tx.update(nest(g), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
        for n, a, w in zip(names, got[k], unnest(params)):
            np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-7,
                                       err_msg=f'{n} after call {k}')
    if accum == 2:
        np.testing.assert_array_equal(got[0][0], init[names[0]])
        assert opt.count == 2 and opt.mini_step == 0


def _at(tree, name):
    *head, leaf = name.split('.')
    for k in head:
        tree = tree[k]
    return tree['kernel' if leaf == 'weight' else 'bias']


def _train_inputs(seed=1):
    rng = np.random.default_rng(seed)
    imgs_raw = rng.uniform(0, 255, (2, 72, 72, 3)).astype(np.float32)
    imgs_norm = imgs_raw / 255. - 0.5
    _, cues, labels, _ = _toy()
    return imgs_norm, imgs_raw, np.asarray(cues), np.asarray(labels)


@pytest.mark.parametrize('method', ['SEC', 'DSRG'])
def test_train_step_equals_jax(monkeypatch, method):
    replay = ReplayDropout()
    monkeypatch.setattr(backbones, 'dropout', replay)
    imgs_norm, imgs_raw, cues, labels = _train_inputs()
    _, np_params, _ = bridged_deeplab(method, 4, 72, seed=3)
    jt = jax_train.SECDSRGTrainer(method, 'VOC2012', num_classes=4,
                                  base_lr=5e-3, crf_cfg=CFG)
    jt.init(jax.random.PRNGKey(0), jnp.asarray(imgs_norm))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    opt_state = jt.tx.init(params)
    rng = jax.random.PRNGKey(7)
    _, masks = _dropout_masks(lambda p, x, r: jt.net.apply(
        {'params': p}, x, train=True, rngs={'dropout': r}))(
            params, jnp.asarray(imgs_norm), rng)
    assert len(masks) == (2 if method == 'SEC' else 8)
    params, opt_state, parts_ref = jt.jitted_step()(
        params, opt_state, jnp.asarray(imgs_norm), jnp.asarray(imgs_raw),
        jnp.asarray(cues), jnp.asarray(labels), rng)

    trainer = sec_dsrg.SECDSRGTrainer(method, 4, base_lr=5e-3,
                                      crf_cfg=PORT_CFG, device='cpu')
    load_flax_deeplab(trainer.net, np_params)
    replay.masks = list(masks)
    parts = trainer.train_step(imgs_norm, imgs_raw, cues, labels,
                               torch.Generator().manual_seed(0))
    assert not replay.masks
    assert set(parts) == set(parts_ref)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(parts_ref[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    got = jax.tree_util.tree_leaves(deeplab_params(trainer.net))
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, params))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('method', ['SEC', 'DSRG'])
def test_losses_fall_over_six_steps(method):
    """tests/test_sec_dsrg.py's training check on the port: from random
    weights, six steps at base_lr 5e-3 lower the total loss."""
    imgs_norm, imgs_raw, cues, labels = _train_inputs()
    trainer = sec_dsrg.SECDSRGTrainer(method, 4, base_lr=5e-3,
                                      crf_cfg=PORT_CFG, device='cpu')
    trainer.init(torch.Generator().manual_seed(0))
    losses = [float(trainer.train_step(
        imgs_norm, imgs_raw, cues, labels,
        torch.Generator().manual_seed(i))['total']) for i in range(6)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
