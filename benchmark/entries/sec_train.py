"""SEC training: ``SECDSRGTrainer.train_step`` on host batches, each step
as ``cli.sec_dsrg --task train`` takes it: the uint8 batch to the card,
normalized, the step with dropout from a generator seeded by the step,
each loss part read back to the host.

Set-up builds the one trainer the window drives; its first
``checked_steps`` steps are the ones the check follows, and
``warmup_calls`` more steps finish warming it up before the window goes
on from there.  Compared against the plain reference's training from the
same weights, batches and dropout draws: each checked step's loss, the
first gradient as the optimizer took it (its momentum buffer after one
step: the gradient plus the kernels' weight decay), and the parameters'
change over the checked steps, each by its worst leaf."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.harness import spec
from benchmark.harness import traffic as T
from benchmark.harness import weights as W
from benchmark.harness.checks import leaf_norm_gap
from benchmark.harness.entry import EntryBase
from benchmark.reference import sec as ref_sec
from benchmark.reference.numerics import Numerics


class Entry(EntryBase):
    MACS = 'train_macs'

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 ranges):
        from wsss_tpu_torch.data import registry
        from wsss_tpu_torch.methods.gradcam_cues import _normalizer
        from wsss_tpu_torch.train.sec_dsrg import SECDSRGTrainer

        super().__init__(cfg, traffic, seed, device)
        self.cues, self.tags = T.train_cues(seed, traffic, traffic['pool'],
                                            cfg['classes'])
        self.dropout_seed = T.sub_seed(seed, 'dropout')
        shapes = spec.flops(cfg['name']).kernel_shapes(cfg)['fcn']
        self.layers = W.make_layers(shapes,
                                    T.sub_seed(seed, 'weights'), device)
        with torch.device(device):
            self.program = SECDSRGTrainer(
                cfg['method'], cfg['classes'],
                base_lr=cfg['optimizer']['base_lr'], device=device)
        W.load_into(self.program.net, self.layers)
        self.norm = _normalizer(registry.get(cfg['dataset']).norm_sec,
                                device)
        ranges.hook(self.program.net, 'net.fcn')

        params = list(self.program.net.parameters())
        p0 = [p.detach().clone() for p in params]
        self.losses = []
        for i in range(traffic['checked_steps']):
            self.call(i, self.inputs(i))
            self.losses.append(self.last)
            if i == 0:
                state = self.program.tx.sgd.state
                self.grads = [state[p]['momentum_buffer'].clone()
                              if 'momentum_buffer' in state.get(p, {})
                              else torch.zeros_like(p) for p in params]
        self.change = [p.detach() - q for p, q in zip(params, p0)]
        self.warm_up(traffic['checked_steps'])

    def keep(self, calls: List[int]) -> None:
        """The check follows set-up's steps, not the window's."""

    def warm_up(self, first: int = 0) -> None:
        for i in range(first, first + self.traffic['warmup_calls']):
            self.call(i, self.inputs(i))

    def inputs(self, i: int):
        picks = self.order[i % len(self.order)]
        return (T.gather(self.pool, picks), self.cues[picks[:, 1]],
                self.tags[picks[:, 1]])

    def generator(self, i: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(
            self.dropout_seed + i)

    def call(self, i: int, inp) -> int:
        batch, cues, tags = inp
        imgs = torch.as_tensor(batch).to(self.device, torch.float32)
        parts = self.program.train_step(self.norm(imgs), imgs, cues, tags,
                                        self.generator(i))
        self.last = {k: float(v) for k, v in parts.items()}
        return batch.shape[0]

    def reference_outputs(self, mode: str, rows: int = None):
        """The reference's checked steps; ``rows`` keeps only the first
        rows of each batch (the half-batch fault, put in the program's
        place)."""
        losses, grads = [], None
        with Numerics(mode, self.device) as num:
            ref = ref_sec.Trainer(num, self.cfg, self.layers)
            for i in range(self.traffic['checked_steps']):
                batch, cues, tags = (a[:rows] for a in self.inputs(i))
                imgs = torch.as_tensor(batch).to(self.device).float()
                losses.append(ref.step(
                    imgs, torch.as_tensor(cues, device=self.device),
                    torch.as_tensor(tags, device=self.device),
                    self.generator(i)))
                if i == 0:
                    grads = [b.clone() for b in ref.bufs]
            change = [p.detach() - q for p, q in zip(
                ref.params, [t for wb in self.layers for t in wb])]
        return {'losses': losses, 'grads': grads, 'change': change}

    def gaps(self, got: dict, ref: dict) -> dict:
        gn = [float(torch.linalg.vector_norm(g.double()))
              for g in ref['grads']]
        med = float(np.median(gn))
        # leaves with no gradient to speak of move by round-off alone
        skip = [g < 1e-3 * med for g in gn]
        return {
            'loss_gap': max(abs(a['total'] - b['total']) / abs(b['total'])
                            for a, b in zip(got['losses'], ref['losses'])),
            'grad_gap': leaf_norm_gap(got['grads'], ref['grads']),
            'change_gap': leaf_norm_gap(got['change'], ref['change'], skip)}

    def program_outputs(self) -> dict:
        return {'losses': self.losses, 'grads': self.grads,
                'change': self.change}
