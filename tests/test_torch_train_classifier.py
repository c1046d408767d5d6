"""The port's classifier training (01_train) against the JAX package's:
``bce_loss``, and ``ClassifierTrainer.train_step`` from the same bridged
variables on the same batch, with flax's dropout masks replayed in the
port (the two draw their masks from different random streams).

What is held, within 1e-4 (absolute and relative): the loss and the
batch F1 of every step, and after one and three steps every parameter
and BatchNorm statistic.  M7 has BatchNorm and a dropout before its
head, VGG16 (BN) BatchNorm and two dropouts in its fifth stage; both at
32^2, batch 2: one step in float32, three in float64 (see below).  The
port's own dropout: its keep rate and scale under a seeded generator."""
import contextlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import perturbed_variables
from wsss_tpu.models import build_classifier as jax_build
from wsss_tpu.train import classifier as jax_classifier
from wsss_tpu_torch.io.flax_bridge import (classifier_variables,
                                           load_flax_variables)
from wsss_tpu_torch.models import backbones
from wsss_tpu_torch.train.classifier import ClassifierTrainer, bce_loss

TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def two_torch_threads():
    """Two torch intra-op threads for the module's tests.  The suite runs
    in several worker processes at once, and torch's default of one
    thread per core in each of them leaves the threads spinning on one
    another (these training files ran about five times slower in the
    suite than alone); two threads a worker keep the cores busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dropout_masks(fn):
    """jit(fn) with every flax Dropout's keep mask (``out != 0``) returned
    beside fn's result, in call order."""
    def run(*args):
        masks = []

        def icpt(next_fun, a, kw, ctx):
            out = next_fun(*a, **kw)
            if (isinstance(ctx.module, nn.Dropout)
                    and ctx.method_name == '__call__'):
                masks.append(out != 0)
            return out
        with nn.intercept_methods(icpt):
            res = fn(*args)
        return res, masks
    jitted = jax.jit(run)
    return lambda *args: tuple(
        jax.tree_util.tree_map(np.asarray, jitted(*args)))


class ReplayDropout:
    """Stands in for ``backbones.dropout``: applies the next recorded
    flax mask (NHWC masks go to the port's NCHW activations)."""

    def __init__(self):
        self.masks = []

    def __call__(self, x, rate, generator):
        m = torch.from_numpy(np.array(self.masks.pop(0)))
        if m.ndim == 4:
            m = m.permute(0, 3, 1, 2)
        assert m.shape == x.shape, (m.shape, x.shape)
        return torch.where(m, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))


@pytest.fixture
def replay(monkeypatch):
    r = ReplayDropout()
    monkeypatch.setattr(backbones, 'dropout', r)
    return r


@pytest.mark.parametrize('weighted', [False, True])
def test_bce_loss_equals_jax(weighted):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 7)).astype(np.float32)
    targets = (rng.random((4, 7)) < 0.4).astype(np.float32)
    w = rng.uniform(0.5, 4, 7).astype(np.float32) if weighted else None
    got = bce_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                   None if w is None else torch.from_numpy(w))
    want = jax_classifier.bce_loss(jnp.asarray(logits), jnp.asarray(targets),
                                   None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _batch(n_cls, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, size, size, 3)).astype(np.float32)
    t = (rng.random((2, n_cls)) < 0.5).astype(np.float32)
    return x, t


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _tree_close(got, want, prefix=''):
    assert set(got) == set(want), (prefix, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], f'{prefix}/{k}')
        else:
            _close(got[k], np.asarray(want[k]), f'{prefix}/{k}')


def _x64(on):
    return jax.enable_x64(True) if on else contextlib.nullcontext()


# These BatchNorm nets at this toy size (random weights, batch 2; VGG16
# has a 4x4 map in stages 4-5) are ill-conditioned in float32: VGG16's
# float32 gradients differ from its float64 ones by up to 1e-2 (of a
# largest gradient of ~1.6), so two float32 implementations drift apart
# over a few updates whatever their order of sums (M7 by 1.7e-4 after
# three).  One step is held in float32, the precision the port trains
# in; three steps run both packages in float64, where the arithmetic of
# the momentum, the schedule and the statistics is held and not the
# rounding.
@pytest.mark.parametrize('tag,n_steps,x64', [
    ('M7', 1, False), ('M7', 3, True), ('VGG16', 1, False),
    ('VGG16', 3, True)])
def test_train_steps_equal_jax(replay, tag, n_steps, x64):
    n_cls, size = 5, 32
    weights = np.array([1.0, 2.0, 0.5, 3.0, 1.5], np.float32)
    kw = dict(lr=0.01, schedule='clr')
    with _x64(x64):
        model, variables = perturbed_variables(tag, n_cls, size, seed=1)
        if x64:
            model = jax_build(tag, n_cls, dtype=jnp.float64)
            variables = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables)
        jt = jax_classifier.ClassifierTrainer(model, class_weights=weights,
                                              **kw)
        params = variables['params']
        state = {'batch_stats': variables['batch_stats']}
        opt_state = jt.tx.init(params)
        step = jt.jitted_step()
        masks_of = _dropout_masks(lambda v, x, r: model.apply(
            v, x, train=True, rngs={'dropout': r}, mutable=['batch_stats'],
            method='logits'))

        dtype = torch.float64 if x64 else torch.float32
        net = load_flax_variables(
            backbones.build_classifier(tag, n_cls, dtype=dtype), variables)
        trainer = ClassifierTrainer(net.to(dtype), class_weights=weights,
                                    device='cpu', **kw)
        for k in range(n_steps):
            x, t = _batch(n_cls, size, seed=10 + k)
            xj = jnp.asarray(x, jnp.float64 if x64 else jnp.float32)
            rng = jax.random.PRNGKey(100 + k)
            _, masks = masks_of(variables, xj, rng)
            assert len(masks) == (1 if tag == 'M7' else 2)
            replay.masks = list(masks)
            params, state, opt_state, m_ref = step(
                params, state, opt_state, xj, jnp.asarray(t), rng)
            m = trainer.train_step(torch.from_numpy(x), torch.from_numpy(t),
                                   torch.Generator().manual_seed(k))
            assert not replay.masks
            _close(float(m['loss']), float(m_ref['loss']), f'loss {k}')
            _close(float(m['f1']), float(m_ref['f1']), f'f1 {k}')
        got = classifier_variables(trainer.model)
        _tree_close(got['params'], jax.tree_util.tree_map(np.asarray, params))
        _tree_close(got['batch_stats'],
                    jax.tree_util.tree_map(np.asarray, state['batch_stats']))


def test_eval_scores_equal_jax():
    n_cls, size = 5, 32
    model, variables = perturbed_variables('M7', n_cls, size, seed=2)
    jt = jax_classifier.ClassifierTrainer(model)
    x, _ = _batch(n_cls, size, seed=3)
    want = jt.eval_scores(variables['params'],
                          {'batch_stats': variables['batch_stats']},
                          jnp.asarray(x))
    net = load_flax_variables(backbones.build_classifier('M7', n_cls),
                              variables)
    got = ClassifierTrainer(net, device='cpu').eval_scores(
        torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), 'scores')


def test_dropout_keep_rate_and_scale():
    x = torch.ones((200, 500))
    y = backbones.dropout(x, 0.5, torch.Generator().manual_seed(0))
    kept = y != 0
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    y2 = backbones.dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    y3 = backbones.dropout(x, 0.25, torch.Generator().manual_seed(1))
    assert abs(float((y3 != 0).float().mean()) - 0.75) < 0.01
    np.testing.assert_allclose(float(y3.max()), 1 / 0.75, rtol=1e-6)
    with pytest.raises(ValueError, match='needs a torch.Generator'):
        backbones.dropout(x, 0.5, None)
    drop = backbones.Dropout(0.5).eval()
    assert drop(x) is x


def _flat_params(net):
    """Every parameter of ``net``, flattened into one float64 vector (the
    parameters stay float32 under bf16)."""
    return np.concatenate([p.detach().double().ravel().numpy()
                           for p in net.parameters()])


# bf16 rounding at this toy size (M7, 32^2, batch 2) is noise that the
# BatchNorm nets amplify: two bf16 steps that round at different points
# are as far apart as a bf16 step from a float32 one.  Measured against
# flax's bf16 step: the port's bf16 loss 4.7e-3 relative, its update
# 0.346 of the update's norm, its BatchNorm statistics 1.1e-4; a float32
# step 1.8e-3, 0.367 and 1.2e-4.  So the limits on those three are set
# about 1.5-4x above the observed gaps, and what tells bf16 from float32
# is the head's bf16 output inside the step and the update's distance
# from the port's float32 step (0.296 of its norm, held at 0.1 or more).
def test_bf16_switch_trains_in_bf16_like_the_reference(monkeypatch,
                                                       replay):
    """Under WSSS_TPU_BF16_INFER both packages build the classifier in
    bf16 when the trainer asks for the default dtype; one M7 step trains
    float32 parameters through bf16 convolutions and head, near flax's
    bf16 step (limits above) and away from a float32 step."""
    monkeypatch.setenv('WSSS_TPU_BF16_INFER', '1')
    n_cls, size = 5, 32
    model = jax_build('M7', n_cls)
    assert model.dtype == jnp.bfloat16
    _, variables = perturbed_variables('M7', n_cls, size, seed=1)
    jt = jax_classifier.ClassifierTrainer(model, lr=0.01)
    x, t = _batch(n_cls, size, seed=10)
    rng = jax.random.PRNGKey(100)
    _, masks = _dropout_masks(lambda v, x_, r: model.apply(
        v, x_, train=True, rngs={'dropout': r}, mutable=['batch_stats'],
        method='logits'))(variables, jnp.asarray(x), rng)
    params, state, _, m_ref = jt.jitted_step()(
        variables['params'], {'batch_stats': variables['batch_stats']},
        jt.tx.init(variables['params']), jnp.asarray(x), jnp.asarray(t), rng)

    def bridged(vs):
        return load_flax_variables(backbones.build_classifier('M7', n_cls),
                                   vs)
    before = _flat_params(bridged(variables))
    upd_ref = _flat_params(bridged({'params': params, **state})) - before

    def step(dtype):
        net = bridged(variables)
        assert net.dtype == dtype
        head_dtypes = []
        head_logits = net.head_logits

        def recorded(*a):
            out = head_logits(*a)
            head_dtypes.append(out.dtype)
            return out
        net.head_logits = recorded
        replay.masks = list(masks)
        m = ClassifierTrainer(net, lr=0.01, device='cpu').train_step(
            torch.from_numpy(x), torch.from_numpy(t),
            torch.Generator().manual_seed(0))
        assert head_dtypes == [dtype]
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in net.parameters())
        return net, float(m['loss']), _flat_params(net) - before

    net, loss, upd = step(torch.bfloat16)
    np.testing.assert_allclose(loss, float(m_ref['loss']), rtol=2e-2)
    gap = np.linalg.norm(upd - upd_ref) / np.linalg.norm(upd_ref)
    assert gap <= 0.5, gap
    for g, w in zip(
            jax.tree_util.tree_leaves(classifier_variables(net)['batch_stats']),
            jax.tree_util.tree_leaves(state['batch_stats'])):
        np.testing.assert_allclose(g, np.asarray(w), atol=4e-4, rtol=0)
    # and the bf16 step is not the float32 one
    monkeypatch.delenv('WSSS_TPU_BF16_INFER')
    _, _, upd_f32 = step(torch.float32)
    away = np.linalg.norm(upd - upd_f32) / np.linalg.norm(upd_f32)
    print(f'bf16 step: update {gap:.3f} of flax bf16, {away:.3f} of f32')
    assert away >= 0.1, away
