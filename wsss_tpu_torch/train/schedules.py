"""Learning-rate schedules and the SGD of the port's trainers (counterpart
of ``wsss_tpu/train/schedules.py``).

  * Cyclic LR (triangular) — 01_train/demo.py:90-110: a triangular wave
    between base_lr and max_lr with half-cycle ``step_size``.
  * Step decay — 01_train's lr-drop path and 03a's 0.5x every 4 epochs
    (model.py:38-39,493).
  * Poly decay — 03b's PolyOptimizer (train_irn.py:87-90):
    lr * (1 - step/max_step)**0.9.

A schedule is a plain function of the update count: the number of updates
already applied, so the first update uses ``sched(0)``, as optax's
``scale_by_learning_rate`` counts.  It computes in float32, the dtype the
reference's schedules compute in on optax's int32 count, so the values
are the reference's bit for bit (except a few ulps where step_decay's
factor is not a power of two: XLA's float32 power is not numpy's).

``ScheduledSGD`` is ``torch.optim.SGD`` with that count: before each
update it sets every parameter group's ``lr`` to ``sched(count) * mult``.
With ``every_k > 1`` it is optax's ``MultiSteps``: each call adds the
gradients into their running mean, and every k-th call applies one update
with the mean; the count advances on applied updates only.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Union

import numpy as np
import torch

F32 = np.float32
Schedule = Callable[[int], float]


def cyclic_lr(base_lr: float, max_lr: float, step_size: int) -> Schedule:
    def sched(count: int) -> float:
        c, s = F32(count), F32(step_size)
        cycle = np.floor(F32(1) + c / (F32(2) * s))
        x = np.abs(c / s - F32(2) * cycle + F32(1))
        return float(F32(base_lr) + F32(max_lr - base_lr)
                     * np.maximum(F32(0), F32(1) - x))
    return sched


def step_decay(base_lr: float, drop: float, steps_per_drop: int
               ) -> Schedule:
    def sched(count: int) -> float:
        return float(F32(base_lr)
                     * F32(drop) ** F32(count // steps_per_drop))
    return sched


def poly_decay(base_lr: float, max_step: int, power: float = 0.9
               ) -> Schedule:
    def sched(count: int) -> float:
        frac = np.clip(F32(count) / F32(max_step), F32(0), F32(1))
        return float(F32(base_lr) * (F32(1) - frac) ** F32(power))
    return sched


def constant(lr: float) -> Schedule:
    return lambda count: float(F32(lr))


class ScheduledSGD:
    """SGD with momentum whose step size follows ``schedule`` of the update
    count, with optax MultiSteps accumulation over ``every_k`` calls.

    groups: ``torch.optim`` parameter groups; a group's ``mult`` (default
    1) scales its schedule, its ``weight_decay`` (default 0) is added to
    the gradient before the momentum trace, as optax's
    ``add_decayed_weights`` precedes ``trace``."""

    def __init__(self, groups: Iterable[Dict], schedule: Schedule,
                 momentum: float, nesterov: bool, every_k: int = 1):
        groups = [dict(g) for g in groups]
        for g in groups:
            g.setdefault('mult', 1.0)
            g['params'] = list(g['params'])
        self.sgd = torch.optim.SGD(groups, lr=0.0, momentum=momentum,
                                   nesterov=nesterov)
        self.schedule = schedule
        self.every_k = every_k
        self.count = 0          # updates applied
        self.mini_step = 0      # gradients in the running mean
        self.acc: List[torch.Tensor] = []

    def params(self) -> List[torch.Tensor]:
        return [p for g in self.sgd.param_groups for p in g['params']]

    @torch.no_grad()
    def step(self) -> bool:
        """Apply the parameters' ``.grad``; returns whether an update was
        applied (always when every_k is 1).  Gradients are left as they
        are: the caller zeroes them."""
        if self.every_k > 1:
            params = self.params()
            if not self.acc:
                self.acc = [torch.zeros_like(p) for p in params]
            n = self.mini_step
            for a, p in zip(self.acc, params):
                a.add_((p.grad - a) / (n + 1))
            if n < self.every_k - 1:
                self.mini_step += 1
                return False
            for a, p in zip(self.acc, params):
                p.grad.copy_(a)
                a.zero_()
            self.mini_step = 0
        lr = self.schedule(self.count)
        for g in self.sgd.param_groups:
            g['lr'] = lr * g['mult']
        self.sgd.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {'sgd': self.sgd.state_dict(), 'count': self.count,
                'mini_step': self.mini_step, 'acc': list(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state['sgd'])
        self.count = int(state['count'])
        self.mini_step = int(state['mini_step'])
        params = self.params()
        self.acc = [a.to(p.device) for a, p in zip(state['acc'], params)]


def sgd_nesterov(params: Iterable[torch.Tensor],
                 lr: Union[float, Schedule], momentum: float = 0.9,
                 weight_decay: float = 0.0) -> ScheduledSGD:
    """SGD + Nesterov momentum (01_train/demo.py:60-61): optax's
    ``sgd(lr, momentum, nesterov=True)``, after ``add_decayed_weights``
    when weight_decay is set."""
    sched = lr if callable(lr) else constant(lr)
    return ScheduledSGD([{'params': params, 'weight_decay': weight_decay}],
                        sched, momentum, nesterov=True)
