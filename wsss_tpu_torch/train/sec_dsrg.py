"""03a of the port: SEC / DSRG training and prediction (counterpart of
``wsss_tpu/train/sec_dsrg.py``).

From 03a_sec-dsrg/model.py, as the reference keeps them:
  * Momentum 0.9, base_lr 1e-4, weight decay 5e-4 on the kernels only
    (model.py:36-40)
  * per-variable LR multipliers: x1 conv kernels, x2 biases, x10 final
    (fc8) kernels, x20 fc8 biases (model.py:391-398; SEC.py:340-345)
  * LR decays x0.5 every ``steps_per_decay`` updates (model.py:38-39,493)
  * gradient accumulation over accum_num steps (model.py:399-404), as
    optax.MultiSteps: the running mean of the k gradients is applied on
    every k-th call.

optax's chain (decayed weights, trace, multipliers, -lr) is one
``torch.optim.SGD`` with a parameter group per multiplier label: group
lr = schedule * multiplier and weight decay on the weights only give the
same update.  The CRF layer and (for DSRG) the region growing run inside
the step on the tensors' device, with no gradient.  The step runs over a
mesh's 'data' shards (one shard without a mesh) with the global batch's
losses and dropout masks.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from wsss_tpu_torch.io.flax_bridge import load_flax_deeplab
from wsss_tpu_torch.methods.dsrg import dsrg_losses
from wsss_tpu_torch.methods.sec import sec_losses
from wsss_tpu_torch.models.backbones import init_random
from wsss_tpu_torch.models.deeplab import DSRGNet, SECNet
from wsss_tpu_torch.ops.crf import config as crf_config
from wsss_tpu_torch.parallel.mesh import (Mesh, cross_shard_sum,
                                          step_over_shards)
from wsss_tpu_torch.train import schedules
from wsss_tpu_torch.utils.device import resolve_device
from wsss_tpu_torch.utils.timing import span

MULTIPLIERS = {'kernel': 1.0, 'bias': 2.0,
               'final_kernel': 10.0, 'final_bias': 20.0}
MOMENTUM = 0.9
WEIGHT_DECAY = 5e-4
LR_DECAY = 0.5


def lr_multiplier_label(name: str) -> str:
    """A parameter's LR-multiplier group (SEC.py:340-345) from its
    ``named_parameters`` name: fc8 sits at ``head.fc8`` in SECNet and at
    ``branches.{k}.fc8`` in DSRGNet."""
    names = name.split('.')
    is_bias = names[-1] == 'bias'
    if 'fc8' in names:
        return 'final_bias' if is_bias else 'final_kernel'
    return 'bias' if is_bias else 'kernel'


def make_optimizer(net: torch.nn.Module, base_lr: float = 1e-4,
                   steps_per_decay: int = 1000,
                   accum_num: int = 1) -> schedules.ScheduledSGD:
    """Momentum + per-variable LR multipliers + step decay + accumulation
    over ``net``'s parameters."""
    groups: Dict[str, list] = {k: [] for k in MULTIPLIERS}
    for name, p in net.named_parameters():
        groups[lr_multiplier_label(name)].append(p)
    return schedules.ScheduledSGD(
        [{'params': ps, 'mult': MULTIPLIERS[label],
          'weight_decay': WEIGHT_DECAY if label.endswith('kernel') else 0.0}
         for label, ps in groups.items() if ps],
        schedules.step_decay(base_lr, LR_DECAY, steps_per_decay),
        MOMENTUM, nesterov=False, every_k=accum_num)


def _build_net(method: str, num_classes: int) -> torch.nn.Module:
    if method == 'SEC':
        return SECNet(num_classes)
    if method == 'DSRG':
        return DSRGNet(num_classes)
    raise ValueError(method)


class SECDSRGTrainer:
    """A SECNet ('SEC') or DSRGNet ('DSRG') on ``device`` with its
    optimizer; ``train_step`` is one call of the reference's step."""

    def __init__(self, method: str, num_classes: int,
                 base_lr: float = 1e-4, accum_num: int = 1,
                 crf_cfg: Optional[crf_config.CRFConfig] = None,
                 device='cuda'):
        self.device = resolve_device(device)
        self.method = method.upper()
        self.net = _build_net(self.method, num_classes).to(self.device)
        self.crf_cfg = crf_cfg or (crf_config.SEC_TRAIN_DEFAULT
                                   if self.method == 'SEC'
                                   else crf_config.DSRG_TRAIN)
        self.num_classes = num_classes
        self.base_lr = base_lr
        self.accum_num = accum_num
        self.tx = self._optimizer()

    def _optimizer(self) -> schedules.ScheduledSGD:
        return make_optimizer(self.net, base_lr=self.base_lr,
                              accum_num=self.accum_num)

    def init(self, generator: torch.Generator) -> None:
        """flax's default initialisation drawn from ``generator`` (a CPU
        generator), and a fresh optimizer state."""
        init_random(self.net, generator)
        self.tx = self._optimizer()

    def loss_fn(self, net: torch.nn.Module, imgs_norm: torch.Tensor,
                imgs_raw: torch.Tensor, cues: torch.Tensor,
                labels: torch.Tensor, generator: torch.Generator
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The method's losses of ``net`` (the trainer's, or a replica of
        it) in train mode on one batch."""
        logits = net.train()(imgs_norm, generator)
        with span('wsss.train.losses'):
            if self.method == 'SEC':
                return sec_losses(logits, cues, labels, imgs_raw,
                                  self.crf_cfg)
            return dsrg_losses(logits, cues, labels, imgs_raw, self.crf_cfg)

    def train_step(self, imgs_norm, imgs_raw, cues, labels,
                   generator: torch.Generator, mesh: Optional[Mesh] = None
                   ) -> Dict[str, torch.Tensor]:
        """One call of the step on NHWC batches (normalized and raw
        images, [B,41,41,C] cues, [B,C] tags): forward, losses, backward,
        optimizer.  The dropout masks come from ``generator`` (on the
        net's device).  Returns the detached loss parts and 'total'.

        The step runs over ``mesh``'s 'data' shards (None: one shard on
        the net's device), ``parallel.mesh.step_over_shards``, with the
        global batch's dropout masks; the CRF layer and the region growing
        stay per shard (per image).  Every loss part is a batch mean of
        per-image terms, so each is the cross-shard sum of its shards'
        sums over B; 'grown_px' is summed; 'total' is the sum of the
        parts."""
        def forward(net, dev, *xs):
            _, parts = self.loss_fn(net, *(x.to(torch.float32) for x in xs),
                                    generator)
            rows = xs[0].shape[0]
            return {k: v if k == 'grown_px' else v * rows
                    for k, v in parts.items()}

        def combine(outs, devices, batch):
            b = batch[0].shape[0]
            parts = {}
            for k in outs[0]:
                s = cross_shard_sum([o[k] for o in outs], devices)[0]
                parts[k] = s if k == 'grown_px' else s / b
            loss = sum(v for k, v in parts.items() if k != 'grown_px')
            parts = {k: v.detach() for k, v in parts.items()}
            parts['total'] = loss.detach()
            return loss, parts

        return step_over_shards(self, self.net, self.tx, mesh, forward,
                                combine, imgs_norm, imgs_raw, cues, labels,
                                generator=generator)

    @torch.no_grad()
    def predict_logits(self, imgs_norm: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC images -> NHWC logits on the /8 grid (eval
        mode)."""
        with span('wsss.sec.fcn'):
            return self.net.eval()(imgs_norm.to(self.device, torch.float32))

    def state_dict(self) -> dict:
        """The training checkpoint: the network's state dict under
        'params' (what ``SECDSRGPredictor`` restores) and the optimizer's
        state under 'opt_state'."""
        return {'params': self.net.state_dict(),
                'opt_state': self.tx.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.net.load_state_dict(state['params'])
        if 'opt_state' in state:
            self.tx.load_state_dict(state['opt_state'])


class SECDSRGPredictor:
    """A SECNet ('SEC') or DSRGNet ('DSRG') in eval mode on ``device``.
    Its weights are flax's default initialisation drawn from a
    torch.Generator seeded with ``seed`` until ``from_flax`` replaces
    them."""

    def __init__(self, method: str, num_classes: int, device='cuda',
                 seed: int = 0):
        self.device = resolve_device(device)
        method = method.upper()
        net = _build_net(method, num_classes)
        self.method = method
        self.num_classes = num_classes
        init_random(net, torch.Generator().manual_seed(seed))
        self.net = net.to(self.device).eval()

    @classmethod
    def random(cls, method: str, num_classes: int, seed: int = 0,
               device='cuda'):
        """Untrained predictor with weights drawn from ``seed``."""
        return cls(method, num_classes, device=device, seed=seed)

    @classmethod
    def from_flax(cls, method: str, numpy_params: Mapping, device='cuda'):
        """Predictor carrying the JAX package's flax ``params`` tree
        (numpy leaves) across through ``io.flax_bridge``."""
        head = 'head' if method.upper() == 'SEC' else 'branch6'
        num_classes = np.shape(numpy_params[head]['fc8']['bias'])[0]
        self = cls(method, num_classes, device=device)
        load_flax_deeplab(self.net, numpy_params)
        return self

    @torch.no_grad()
    def predict_logits(self, imgs_norm: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC images -> NHWC logits on the /8 grid."""
        with span('wsss.sec.fcn'):
            return self.net(imgs_norm.to(self.device, torch.float32))
