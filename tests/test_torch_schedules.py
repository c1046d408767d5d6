"""The port's schedules and SGD against the JAX package's (optax).

Schedules: every value equal to the reference's on optax's int32 count,
at counts around every boundary; with a decay factor that is not a power
of two (0.1) within 1e-6 relative, as XLA's float32 power of an integer
exponent is not numpy's (a few ulps apart).  The reference's CLIs decay
by 0.5, where the values are equal.  ``sgd_nesterov``: five updates from
the same parameters and gradients equal optax's within 1e-6 (two float32
roundings apart: optax scales the trace by -lr and adds, torch adds with
alpha -lr)."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wsss_tpu.train import schedules as jax_sched
from wsss_tpu_torch.train import schedules

COUNTS = sorted({c + d for c in (0, 50, 99, 100, 150, 199, 200, 300, 399,
                                 400, 1000, 2000, 4000)
                 for d in (-1, 0, 1) if c + d >= 0})


@pytest.mark.parametrize('name,args,rtol', [
    ('cyclic_lr', (0.001, 0.006, 100), 0),
    ('cyclic_lr', (0.01, 0.06, 2000), 0),
    ('step_decay', (0.1, 0.5, 4), 0),
    ('step_decay', (1e-4, 0.5, 1000), 0),
    ('step_decay', (0.01, 0.1, 1000), 1e-6),
    ('poly_decay', (0.1, 100), 0),
    ('poly_decay', (0.1, 400, 0.9), 0),
])
def test_schedule_equals_jax(name, args, rtol):
    ours = getattr(schedules, name)(*args)
    ref = getattr(jax_sched, name)(*args)
    got = np.array([ours(c) for c in COUNTS], np.float32)
    want = np.array([np.float32(ref(jnp.int32(c))) for c in COUNTS])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _torch_steps(opt, params, grads):
    out = []
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi.copy())
        opt.step()
        out.append([p.detach().numpy().copy() for p in params])
    return out


def _optax_steps(tx, params, grads):
    state = tx.init(params)
    out = []
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, upd)
        out.append([np.asarray(p) for p in params])
    return out


@pytest.mark.parametrize('weight_decay', [0.0, 5e-4])
@pytest.mark.parametrize('schedule', ['const', 'clr'])
def test_sgd_nesterov_equals_optax(weight_decay, schedule):
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (3,), (2, 2, 5)]
    init = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1, s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    if schedule == 'const':
        ours, ref = 0.1, 0.1
    else:
        ours = schedules.cyclic_lr(0.01, 0.06, 2)
        ref = jax_sched.cyclic_lr(0.01, 0.06, 2)
    params = [torch.from_numpy(a.copy()).requires_grad_() for a in init]
    got = _torch_steps(schedules.sgd_nesterov(params, ours, 0.9,
                                              weight_decay), params, grads)
    want = _optax_steps(jax_sched.sgd_nesterov(ref, 0.9, weight_decay),
                        [jnp.asarray(a) for a in init], grads)
    for g_step, w_step in zip(got, want):
        for g, w in zip(g_step, w_step):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_state_dict_round_trip_continues_exactly():
    """Three updates straight equal two, a state_dict round trip into a
    fresh optimizer, and one more (momentum, count, accumulation)."""
    rng = np.random.default_rng(4)
    init = rng.normal(0, 1, (6,)).astype(np.float32)
    grads = [[rng.normal(0, 1, (6,)).astype(np.float32)] for _ in range(6)]
    sched = schedules.step_decay(0.1, 0.5, 2)

    def opt(p):
        return schedules.ScheduledSGD([{'params': p}], sched, 0.9,
                                      nesterov=False, every_k=2)

    p1 = [torch.from_numpy(init.copy())]
    straight = _torch_steps(opt(p1), p1, grads)[-1]
    p2 = [torch.from_numpy(init.copy())]
    o2 = opt(p2)
    _torch_steps(o2, p2, grads[:3])
    state = o2.state_dict()
    p3 = [p2[0].detach().clone()]
    o3 = opt(p3)
    o3.load_state_dict(state)
    assert (o3.count, o3.mini_step) == (1, 1)
    resumed = _torch_steps(o3, p3, grads[3:])[-1]
    np.testing.assert_array_equal(resumed[0], straight[0])
