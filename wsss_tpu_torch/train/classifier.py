"""01_train of the port: multi-label classifier training (counterpart of
``wsss_tpu/train/classifier.py``).

Rebuilds the reference's Keras fit_generator loop (01_train/demo.py:
21-127) as a PyTorch step: binary crossentropy on sigmoid outputs, SGD +
Nesterov momentum 0.9 (demo.py:60-61), optional per-class weighting, CLR
or step-decay schedules, batch-F1 metric (utilities.py:69-97).  The model
trains in train mode: BatchNorm on batch statistics (flax's update of the
running ones) and dropout masks drawn from the step's generator.  The
step runs over a mesh's 'data' shards (one shard without a mesh) with the
global batch's statistics, loss and masks, as the reference's step on a
sharded batch.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from wsss_tpu_torch.eval.metrics import batch_f1
from wsss_tpu_torch.models.backbones import _Classifier, init_random
from wsss_tpu_torch.parallel.mesh import (Mesh, cross_shard_sum,
                                          step_over_shards)
from wsss_tpu_torch.train import schedules
from wsss_tpu_torch.utils.device import resolve_device

# The reference's fixed settings (01_train/demo.py:60-61, 90-110): Nesterov
# momentum, the CLR peak as a multiple of the base LR and its half-cycle,
# and the step schedule's factor and period, all in updates.
MOMENTUM = 0.9
CLR_MAX_MULT = 6.0
CLR_STEP = 2000
LR_DROP = 0.5
LR_DROPSTEP = 2000


def bce_terms(logits: torch.Tensor, targets: torch.Tensor,
              class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy of each logit [B, C], class-weighted."""
    per = -(targets * F.logsigmoid(logits)
            + (1.0 - targets) * F.logsigmoid(-logits))
    if class_weights is not None:
        per = per * class_weights[None, :]
    return per


def bce_loss(logits: torch.Tensor, targets: torch.Tensor,
             class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy over sigmoid logits, mean over batch+classes."""
    return torch.mean(bce_terms(logits, targets, class_weights))


class ClassifierTrainer:
    """Holds the model (moved to ``device``) and its optimizer; one
    ``train_step`` is one SGD update."""

    def __init__(self, model: _Classifier, lr: float = 0.1,
                 schedule: str = 'clr', class_weights=None, device='cuda'):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if schedule == 'clr':
            self.sched = schedules.cyclic_lr(lr, lr * CLR_MAX_MULT, CLR_STEP)
        elif schedule == 'step':
            self.sched = schedules.step_decay(lr, LR_DROP, LR_DROPSTEP)
        else:
            self.sched = schedules.constant(lr)
        self.tx = schedules.sgd_nesterov(self.model.parameters(),
                                         self.sched, MOMENTUM)
        self.class_weights = (
            None if class_weights is None else torch.as_tensor(
                np.asarray(class_weights, np.float32), device=self.device))

    def init(self, generator: torch.Generator) -> None:
        """flax's default initialisation drawn from ``generator`` (a CPU
        generator), and a fresh optimizer state."""
        init_random(self.model, generator)
        self.tx = schedules.sgd_nesterov(self.model.parameters(),
                                         self.sched, MOMENTUM)

    def train_step(self, images, targets, generator: torch.Generator,
                   mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        """One SGD step on normalized NHWC images and [B, C] targets (tensors,
        or ``ShardedBatch``es already on ``mesh``); the dropout masks come
        from ``generator`` (on the model's device).  Returns {'loss', 'f1'}
        as scalar tensors on the device.

        The step runs over ``mesh``'s 'data' shards (None: one shard on the
        model's device), ``parallel.mesh.step_over_shards``: each shard's
        replica runs its rows with the global batch's BatchNorm statistics
        and dropout masks (``models.backbones``); the loss is the
        cross-shard sum of the weighted BCE terms over B * C, and F1 comes
        from the gathered scores."""
        def forward(model, dev, xi, ti):
            logits = model.train().logits(xi.to(torch.float32), generator)
            w = (None if self.class_weights is None
                 else self.class_weights.to(dev))
            return logits, bce_terms(logits, ti.to(torch.float32), w).sum()

        def combine(outs, devices, batch):
            b, c = batch[1].shape
            loss = cross_shard_sum([o[1] for o in outs], devices)[0] / (b * c)
            scores = torch.cat([torch.sigmoid(o[0].detach()).to(self.device)
                                for o in outs])
            targets = batch[1].gather(self.device).to(torch.float32)
            return loss, {'loss': loss.detach(),
                          'f1': batch_f1(targets, scores)}

        return step_over_shards(self, self.model, self.tx, mesh, forward,
                                combine, images, targets,
                                generator=generator)

    @torch.no_grad()
    def eval_scores(self, images: torch.Tensor) -> torch.Tensor:
        """Sigmoid scores [B, C] in eval mode (running statistics, no
        dropout)."""
        scores, _ = self.model.eval()(images.to(self.device, torch.float32))
        return scores

    def state_dict(self) -> dict:
        """The training checkpoint: the model's state dict (parameters and
        BatchNorm statistics) and the optimizer's state."""
        return {'params': self.model.state_dict(),
                'opt_state': self.tx.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state['params'])
        if 'opt_state' in state:
            self.tx.load_state_dict(state['opt_state'])
