"""Data-parallel training of the port on two CPU shards: the step over the
shards (``parallel.mesh.run_shards``, ``Replicas``, ``cross_shard_sum``),
BatchNorm's global statistics and the global dropout masks
(``models.backbones``), and the trainers' ``mesh=`` steps (classifier,
SEC, DSRG, IRNet m7) against the same step without a mesh (one shard on
the trainer's device: the same code) and against the JAX trainers'
jitted steps on a batch placed with ``batch_sharding`` over 2 of the 8
virtual CPU devices (tests/test_cli_mesh.py's claim, held at the trainer
level); a batch the shards do not divide, or one padded to fit, is
refused.

Tolerances: against the unsharded step, each loss within 1e-5 relative
and every parameter and BatchNorm statistic within 1e-5 of its tensor's
largest magnitude; against JAX, the loss within 1e-4 relative and the
parameters within 5e-4 (IRNet: the heads), as
tests/test_torch_train_classifier.py and tests/test_torch_irn_train.py
hold one device.  VGG16 (BN) runs in float64: at 32^2 its float32 step is
ill-conditioned (see tests/test_torch_train_classifier.py), so two orders
of the same sums differ by more than rounding there."""
import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sec_dsrg import CFG
from test_torch_deeplab import bridged_deeplab
from test_torch_irn_train import _heads, _max_diff, _trainers
from test_torch_models import perturbed_variables
from test_torch_train_classifier import (  # noqa: F401
    ReplayDropout, _dropout_masks, _x64, two_torch_threads)
from wsss_tpu.models import build_classifier as jax_build
from wsss_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from wsss_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wsss_tpu.parallel.mesh import replicated as jax_replicated
from wsss_tpu.train import classifier as jax_classifier
from wsss_tpu.train import sec_dsrg as jax_train
from wsss_tpu_torch.io.flax_bridge import (classifier_variables,
                                           deeplab_params, irnet_variables,
                                           load_flax_deeplab,
                                           load_flax_variables)
from wsss_tpu_torch.methods import irnet
from wsss_tpu_torch.models import backbones
from wsss_tpu_torch.ops.crf.config import CRFConfig
from wsss_tpu_torch.parallel import mesh as mesh_mod
from wsss_tpu_torch.parallel.mesh import (Mesh, Replicas, cross_shard_sum,
                                          current_shard, run_shards,
                                          shard_batch)
from wsss_tpu_torch.train import sec_dsrg
from wsss_tpu_torch.train.classifier import ClassifierTrainer

CPU = torch.device('cpu')
SELF_TOL = 1e-5
JAX_LOSS_TOL = 1e-4
JAX_PARAM_TOL = 5e-4


def _mesh(n=2):
    return Mesh([CPU] * n, ('data',))


def _all_sum(t):
    """``cross_shard_sum`` of every shard's t, met inside ``run_shards``."""
    step = current_shard()
    return step.meet(t, lambda parts: cross_shard_sum(parts, step.devices))


def _jax_put(n=2):
    """(batch placer, state replicator) over n virtual CPU devices: the
    reference's dp_train_putters."""
    jm = jax_make_mesh(n)
    bsh, rsh = jax_batch_sharding(jm), jax_replicated(jm)
    return (lambda x: jax.device_put(jnp.asarray(x), bsh),
            lambda t: jax.device_put(t, rsh))


def _state_close(got, want, tol=SELF_TOL):
    """Every floating tensor of two state dicts within tol of the larger
    of its largest magnitude and 1e-30."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), k
            continue
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[k].double() - w.double()).abs().max())
        assert err <= tol * scale, (k, err, scale)


@torch.no_grad()
def _perturb(module, seed):
    """Every bias and norm parameter moved by N(0, 0.1) (flax starts them
    at 0 and 1), so that a tensor's scale is not the step's update
    alone."""
    g = torch.Generator().manual_seed(seed)
    for p in module.parameters():
        if p.ndim == 1:
            p.add_(0.1 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    return module


def _rel_close(got, want, tol, what):
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (what, got, want)


# --- the step over the shards -----------------------------------------------

def test_cross_shard_sum_same_bits_and_gradient_to_every_shard():
    rng = np.random.default_rng(0)
    parts = [torch.tensor(rng.normal(size=5), requires_grad=True)
             for _ in range(3)]
    out = cross_shard_sum(parts, [CPU] * 3)
    want = (parts[0] + parts[1]) + parts[2]
    assert all(torch.equal(o, want) for o in out)
    w = torch.arange(5.0, dtype=torch.float64)
    (out[0] * w).sum().backward()
    for p in parts:
        assert torch.equal(p.grad, w)


def test_run_shards_threads_know_their_shard_and_grad_mode():
    x = torch.ones(4, 2, requires_grad=True)
    (xs,), _ = shard_batch(_mesh(), x.detach())
    seen = {}

    def fn(i, dev, xi):
        s = current_shard()
        seen[i] = (s.index, dev, threading.get_ident(),
                   torch.is_grad_enabled())
        return _all_sum(xi.sum() * x.sum())

    outs = run_shards(_mesh(), fn, xs)
    assert torch.equal(outs[0], outs[1]) and float(outs[0].detach()) == 64.0
    assert [seen[i][0] for i in range(2)] == [0, 1]
    assert len({seen[i][2] for i in range(2)}) == 2
    assert all(seen[i][3] for i in range(2)) and outs[0].requires_grad
    assert current_shard() is None
    with torch.no_grad():
        outs = run_shards(_mesh(), fn, xs)
    assert not any(seen[i][3] for i in range(2))
    assert not outs[0].requires_grad


def test_run_shards_raises_the_failing_shards_error(monkeypatch):
    monkeypatch.setattr(mesh_mod, 'STEP_TIMEOUT_S', 60.0)

    def fn(i, dev):
        if i == 1:
            raise ValueError('shard 1 failed')
        return _all_sum(torch.ones(1))

    with pytest.raises(ValueError, match='shard 1 failed'):
        run_shards(_mesh(), fn)


def test_run_shards_meeting_past_its_bound_raises(monkeypatch):
    monkeypatch.setattr(mesh_mod, 'STEP_TIMEOUT_S', 0.5)

    def fn(i, dev):
        if i == 0:
            return _all_sum(torch.ones(1))
        return torch.ones(1)        # never meets

    with pytest.raises(threading.BrokenBarrierError):
        run_shards(_mesh(), fn)


def test_run_shards_meetings_under_thread_switching_stress(monkeypatch):
    """16 shard threads (more than the cores), 40 meetings each under a
    shortened switch interval: every meeting's sum holds every shard's
    value of that round, on every shard (a lost or late value breaks
    it)."""
    import sys
    monkeypatch.setattr(mesh_mod, 'STEP_TIMEOUT_S', 60.0)
    n, rounds = 16, 40
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = run_shards(_mesh(n), lambda i, dev: [
            _all_sum(torch.tensor([float(r * 100 + i)]))
            for r in range(rounds)])
    finally:
        sys.setswitchinterval(interval)
    for r in range(rounds):
        want = float(sum(r * 100 + i for i in range(n)))
        assert all(float(o[r]) == want for o in outs), r


def test_replicas_one_per_shard_broadcast_and_gradient_sum():
    net = torch.nn.Linear(3, 2)
    reps = Replicas(net, _mesh(3))
    assert reps[0] is net and len({id(m) for m in reps.modules}) == 3
    with torch.no_grad():
        net.weight.add_(1.0)
    reps.broadcast()
    assert all(torch.equal(m.weight, net.weight) for m in reps.modules)
    reps.zero_grad()
    for k, m in enumerate(reps.modules):
        (m(torch.full((1, 3), float(k + 1))).sum()).backward()
    reps.reduce_grads()
    assert torch.allclose(net.weight.grad, torch.full((2, 3), 6.0))
    assert torch.allclose(net.bias.grad, torch.full((2,), 3.0))


@pytest.mark.parametrize('n_shards', [2, 4])
def test_batch_norm_and_dropout_take_the_global_batch(n_shards):
    """A VGG stage with BatchNorm and dropout in train mode: the shards'
    outputs are the unsharded output's rows (its masks, its statistics),
    and every replica's running statistics are the unsharded ones."""
    torch.manual_seed(0)
    stage = backbones.VGGStage((8, 8, 'D'), 3).train()
    backbones.init_random(stage, torch.Generator().manual_seed(1))
    x = torch.randn(4, 3, 6, 6, dtype=torch.float32) * 3 + 1
    ref_stage = copy.deepcopy(stage)
    want = ref_stage(x, torch.Generator().manual_seed(7))
    mesh = _mesh(n_shards)
    reps = Replicas(stage, mesh)
    (xs,), _ = shard_batch(mesh, x)
    outs = run_shards(mesh, lambda i, d, xi: reps[i](
        xi, torch.Generator().manual_seed(7)), xs,
        generator=torch.Generator().manual_seed(7))
    got = torch.cat(outs)
    assert torch.equal(got == 0, want == 0)         # the same masks
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for m in reps.modules:
        for a, b in zip(m.bns, ref_stage.bns):
            torch.testing.assert_close(a.running_mean, b.running_mean,
                                       rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(a.running_var, b.running_var,
                                       rtol=1e-6, atol=1e-7)
        for a, b in zip(m.bns, reps[0].bns):
            assert torch.equal(a.running_mean, b.running_mean)
            assert torch.equal(a.running_var, b.running_var)


# --- a training batch takes no padding ---------------------------------------

def _refusing_trainer(which):
    """(trainer, a step of it on the first n rows of a 4-row batch, or on
    ``ShardedBatch``es given in their place)."""
    gen = torch.Generator().manual_seed(0)
    if which == 'classifier':
        tr = _cls_trainer('M7', 5, torch.float32, None)
        data = _cls_batch(5, 32, 10)
        return (tr, tr.model, lambda xs, m: tr.train_step(*xs, gen, mesh=m),
                data)
    if which == 'SEC':
        tr = sec_dsrg.SECDSRGTrainer('SEC', 4, base_lr=5e-3,
                                     crf_cfg=PORT_CFG, device='cpu')
        tr.init(gen)
        return (tr, tr.net, lambda xs, m: tr.train_step(*xs, gen, mesh=m),
                _sec_inputs())
    tr = irnet.IRNTrainer('m7', crop_size=32, device='cpu')
    tr.init(gen)
    return (tr, tr.net, lambda xs, m: tr.train_step(*xs, mesh=m),
            _irn_batch(tr.path_index))


@pytest.mark.parametrize('which', ['classifier', 'SEC', 'IRNet'])
def test_train_step_refuses_an_indivisible_or_padded_batch(which):
    """Over two shards a batch of 3 rows, or a ``ShardedBatch`` that
    shard_batch padded to 4 (its last row repeated), raises before any
    forward: the repeated row would enter BatchNorm's statistics and the
    loss sums.  The parameters stay as they were."""
    tr, module, step, data = _refusing_trainer(which)
    before = copy.deepcopy(module.state_dict())
    three = [a[:3] for a in data]
    with pytest.raises(ValueError, match='divisible'):
        step(three, _mesh())
    padded, b0 = shard_batch(_mesh(), *three)
    assert b0 == 3 and padded[0].shape[0] == 4
    with pytest.raises(ValueError, match='unpadded'):
        step(padded, _mesh())
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), k


# --- the classifier ----------------------------------------------------------

def _cls_batch(n_cls, size, seed, b=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, size, size, 3)).astype(np.float32)
    t = (rng.random((b, n_cls)) < 0.5).astype(np.float32)
    return x, t


def _cls_trainer(tag, n_cls, dtype, weights):
    net = backbones.build_classifier(tag, n_cls, dtype=dtype)
    backbones.init_random(net, torch.Generator().manual_seed(1))
    _perturb(net, 2)
    return ClassifierTrainer(net.to(dtype), lr=0.01, schedule='clr',
                             class_weights=weights, device='cpu')


@pytest.mark.parametrize('tag,dtype,n_steps', [
    ('M7', torch.float32, 1), ('M7', torch.float64, 2),
    ('VGG16', torch.float64, 2)])
def test_classifier_mesh_step_equals_unsharded(tag, dtype, n_steps):
    """BatchNorm on the global batch, the global dropout masks, the
    class-weighted BCE over B * C and the batch F1 of the gathered
    scores: the --mesh 2 step is the one-device step."""
    n_cls, size = 5, 32
    weights = np.array([1.0, 2.0, 0.5, 3.0, 1.5], np.float32)
    runs = []
    for mesh in (None, _mesh()):
        tr = _cls_trainer(tag, n_cls, dtype, weights)
        ms = []
        for k in range(n_steps):
            x, t = _cls_batch(n_cls, size, 10 + k)
            ms.append(tr.train_step(torch.from_numpy(x), torch.from_numpy(t),
                                    torch.Generator().manual_seed(k),
                                    mesh=mesh))
        runs.append((ms, tr.model.state_dict()))
    (m0, s0), (m1, s1) = runs
    for a, b in zip(m1, m0):
        _rel_close(float(a['loss']), float(b['loss']), SELF_TOL, 'loss')
        _rel_close(float(a['f1']), float(b['f1']), SELF_TOL, 'f1')
    _state_close(s1, s0)


def _tree_max_diff(got, want):
    fa = jax.tree_util.tree_leaves(got)
    fb = jax.tree_util.tree_leaves(want)
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(fa, fb))


@pytest.mark.parametrize('tag,x64', [('M7', False), ('VGG16', True)])
def test_classifier_mesh_step_equals_jax_sharded(monkeypatch, tag, x64):
    replay = ReplayDropout()
    monkeypatch.setattr(backbones, 'dropout', replay)
    n_cls, size = 5, 32
    weights = np.array([1.0, 2.0, 0.5, 3.0, 1.5], np.float32)
    put_batch, put_state = _jax_put()
    with _x64(x64):
        model, variables = perturbed_variables(tag, n_cls, size, seed=1)
        if x64:
            model = jax_build(tag, n_cls, dtype=jnp.float64)
            variables = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables)
        jt = jax_classifier.ClassifierTrainer(model, class_weights=weights,
                                              lr=0.01, schedule='clr')
        params = put_state(variables['params'])
        state = put_state({'batch_stats': variables['batch_stats']})
        opt_state = put_state(jt.tx.init(variables['params']))
        masks_of = _dropout_masks(lambda v, x, r: model.apply(
            v, x, train=True, rngs={'dropout': r}, mutable=['batch_stats'],
            method='logits'))
        x, t = _cls_batch(n_cls, size, 10)
        xj = np.asarray(x, np.float64 if x64 else np.float32)
        rng = jax.random.PRNGKey(100)
        _, masks = masks_of(variables, jnp.asarray(xj), rng)
        params, state, opt_state, m_ref = jt.jitted_step()(
            params, state, opt_state, put_batch(xj), put_batch(t), rng)

        dtype = torch.float64 if x64 else torch.float32
        net = load_flax_variables(
            backbones.build_classifier(tag, n_cls, dtype=dtype), variables)
        tr = ClassifierTrainer(net.to(dtype), lr=0.01, schedule='clr',
                               class_weights=weights, device='cpu')
        replay.masks = list(masks)
        m = tr.train_step(torch.from_numpy(x), torch.from_numpy(t),
                          torch.Generator().manual_seed(0), mesh=_mesh())
        assert not replay.masks
        _rel_close(float(m['loss']), float(m_ref['loss']), JAX_LOSS_TOL,
                   'loss')
        got = classifier_variables(tr.model)
        assert _tree_max_diff(got['params'], params) <= JAX_PARAM_TOL
        assert _tree_max_diff(got['batch_stats'],
                              state['batch_stats']) <= JAX_PARAM_TOL


# --- SEC and DSRG ------------------------------------------------------------

PORT_CFG = CRFConfig(*CFG.astuple())


def _sec_inputs(seed=1, b=4, grid=9, c=4):
    rng = np.random.default_rng(seed)
    imgs_raw = rng.uniform(0, 255, (b, 72, 72, 3)).astype(np.float32)
    cues = np.zeros((b, grid, grid, c), np.float32)
    lab = rng.integers(0, c, (b, grid, grid))
    np.put_along_axis(cues, lab[..., None], 1.0, axis=-1)
    cues *= rng.random((b, grid, grid, 1)) < 0.3
    labels = np.zeros((b, c), np.float32)
    labels[:, 0] = 1
    for i in range(b):
        labels[i, np.unique(lab[i])] = 1
    labels[-1, 1:] = 0              # an image with no foreground tag
    return imgs_raw / 255. - 0.5, imgs_raw, cues, labels


@pytest.mark.parametrize('method', ['SEC', 'DSRG'])
def test_sec_dsrg_mesh_step_equals_unsharded(method):
    inputs = _sec_inputs()
    runs = []
    for mesh in (None, _mesh()):
        tr = sec_dsrg.SECDSRGTrainer(method, 4, base_lr=5e-3,
                                     crf_cfg=PORT_CFG, device='cpu')
        tr.init(torch.Generator().manual_seed(0))
        _perturb(tr.net, 2)
        parts = tr.train_step(*inputs, torch.Generator().manual_seed(3),
                              mesh=mesh)
        runs.append(({k: float(v) for k, v in parts.items()},
                     tr.net.state_dict()))
    (p0, s0), (p1, s1) = runs
    assert p1.keys() == p0.keys()
    for k in p0:
        assert abs(p1[k] - p0[k]) <= SELF_TOL * max(abs(p0[k]), 1.0), k
    _state_close(s1, s0)


@pytest.mark.parametrize('method', ['SEC', 'DSRG'])
def test_sec_dsrg_mesh_step_equals_jax_sharded(monkeypatch, method):
    replay = ReplayDropout()
    monkeypatch.setattr(backbones, 'dropout', replay)
    imgs_norm, imgs_raw, cues, labels = _sec_inputs()
    _, np_params, _ = bridged_deeplab(method, 4, 72, seed=3)
    jt = jax_train.SECDSRGTrainer(method, 'VOC2012', num_classes=4,
                                  base_lr=5e-3, crf_cfg=CFG)
    jt.init(jax.random.PRNGKey(0), jnp.asarray(imgs_norm))
    put_batch, put_state = _jax_put()
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    opt_state = put_state(jt.tx.init(params))
    rng = jax.random.PRNGKey(7)
    _, masks = _dropout_masks(lambda p, x, r: jt.net.apply(
        {'params': p}, x, train=True, rngs={'dropout': r}))(
            params, jnp.asarray(imgs_norm), rng)
    params, opt_state, parts_ref = jt.jitted_step()(
        put_state(params), opt_state, put_batch(imgs_norm),
        put_batch(imgs_raw), put_batch(cues), put_batch(labels), rng)

    tr = sec_dsrg.SECDSRGTrainer(method, 4, base_lr=5e-3, crf_cfg=PORT_CFG,
                                 device='cpu')
    load_flax_deeplab(tr.net, np_params)
    replay.masks = list(masks)
    parts = tr.train_step(imgs_norm, imgs_raw, cues, labels,
                          torch.Generator().manual_seed(0), mesh=_mesh())
    assert not replay.masks
    assert set(parts) == set(parts_ref)
    for k in parts:
        want = float(parts_ref[k])
        assert abs(float(parts[k]) - want) <= JAX_LOSS_TOL * max(
            abs(want), 1.0), k
    assert _tree_max_diff(deeplab_params(tr.net),
                          jax.tree_util.tree_map(np.asarray, params)
                          ) <= JAX_PARAM_TOL


# --- IRNet -------------------------------------------------------------------

def _irn_batch(pidx, seed=3, b=4, crop=32):
    """Images and affinity labels whose second shard (rows b/2 on) holds
    no foreground: the shards' fg_pos counts differ wholly."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(0, 1, (b, crop, crop, 3)).astype(np.float32)
    lab = rng.choice([0, 1, 2, 255], (b, crop // 4, crop // 4),
                     p=[0.4, 0.25, 0.25, 0.1]).astype(np.int64)
    lab[b // 2:] = np.where(lab[b // 2:] == 255, 255, 0)
    packs = [irnet.affinity_labels(x, pidx, 21) for x in lab]
    return (imgs,) + tuple(np.stack(z) for z in zip(*packs))


def test_irn_mesh_step_equals_unsharded_with_unbalanced_shards():
    runs = []
    for mesh in (None, _mesh()):
        _, _, pt = _trainers('m7', 21)
        for name, mod in pt.net.named_children():
            if name != 'trunk':
                _perturb(mod, 2)
        data = _irn_batch(pt.path_index)
        parts = pt.train_step(*data, mesh=mesh)
        runs.append(({k: float(v) for k, v in parts.items()},
                     irnet_variables(pt.net)['params'], data, pt))
    (p0, v0, data, pt), (p1, v1, _, _) = runs
    fg = data[2]
    assert fg[:2].sum() > 0 and fg[2:].sum() == 0
    for k in p0:
        assert abs(p1[k] - p0[k]) <= SELF_TOL * max(abs(p0[k]), 1.0), k
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(_heads(v1))[0],
            jax.tree_util.tree_flatten_with_path(_heads(v0))[0]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= SELF_TOL * scale
    # the ratios of the whole batch, not the mean of each shard's: here
    # the two differ by far more than the tolerance
    _, _, fresh = _trainers('m7', 21)
    with torch.no_grad():
        halves = [fresh.losses(*(torch.from_numpy(a[s]).float()
                                 for a in data))[0]
                  for s in (slice(0, 2), slice(2, 4))]
    averaged = float(sum(halves)) / 2
    assert abs(averaged - p0['total']) > 100 * SELF_TOL * abs(p0['total'])


def test_irn_mesh_step_equals_jax_sharded():
    jt, variables, pt = _trainers('m7', 21)
    data = _irn_batch(pt.path_index)
    put_batch, put_state = _jax_put()
    jv = put_state(jax.tree_util.tree_map(jnp.asarray, variables))
    opt = put_state(jt.tx.init(jv['params']))
    jv, opt, jparts = jt.jitted_step()(jv, opt, *map(put_batch, data))
    trunk0 = {k: v.clone() for k, v in pt.net.trunk.state_dict().items()}
    parts = pt.train_step(*data, mesh=_mesh())
    assert sorted(parts) == sorted(jparts)
    for k, want in jparts.items():
        got, want = float(parts[k]), float(want)
        assert abs(got - want) <= JAX_LOSS_TOL * max(1.0, abs(want)), k
    got = irnet_variables(pt.net)['params']
    want = jax.tree_util.tree_map(np.asarray, jv['params'])
    assert _max_diff(_heads(got), _heads(want)) <= JAX_PARAM_TOL
    for k, v in pt.net.trunk.state_dict().items():
        assert torch.equal(v, trunk0[k]), k
