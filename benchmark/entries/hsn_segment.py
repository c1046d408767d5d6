"""HistoSegNet's main path: ``HSNSegmenter.segment_batch`` on host batches
of uint8 images, labels copied back to the host after each batch (a
closed loop, one client, as ``cli.hsn`` runs a split).

Kept for the check: the CRF's unaries and posterior of the sampled
calls, as the timed path's ``mean_field`` received and returned them.
The reference recomputes both from the same images and weights."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.checks import grid_filter_counter, max_gap
from benchmark.harness.entry import EntryBase, classifier_handles
from benchmark.reference import hsn as ref_hsn
from benchmark.reference.numerics import Numerics


class Entry(EntryBase):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 ranges):
        from wsss_tpu_torch.data import registry
        from wsss_tpu_torch.methods import hsn
        from wsss_tpu_torch.ops.crf import mxu_grid

        super().__init__(cfg, traffic, seed, device)
        # the handles' class thresholds are not used by HistoSegNet
        self.layers, handles = classifier_handles(cfg, seed, device, ranges,
                                                  0.5)
        self.program = hsn.HSNSegmenter(
            registry.get(cfg['dataset']), *handles,
            model_type=cfg['model_tag'], device=device)
        ranges.wrap(hsn, 'mean_field', 'crf.mean_field', self._observe)
        ranges.wrap(mxu_grid.MXUBilateralGrid, 'filter', 'grid.filter',
                    grid_filter_counter(ranges.counters))
        self.warm_up()

    def _observe(self, args, kwargs, q):
        if self.keeping():
            self.kept[self._i] = (args[0], q)

    def call(self, i: int, batch: np.ndarray) -> int:
        self._i = i
        labels = self.program.segment_batch(batch).cpu().numpy()
        return labels.shape[0]

    def reference_outputs(self, mode: str):
        out = {}
        with Numerics(mode, self.device) as num:
            ref = ref_hsn.HSNReference(num, self.cfg, self.layers['fg'],
                                       self.layers['bg'])
            for i in sorted(self.kept):
                imgs = torch.as_tensor(self.inputs(i)).to(self.device)
                p = ref.probs(imgs.float())
                out[i] = (p, ref.crf(p, imgs.float()))
        return out

    def gaps(self, got: dict, ref: dict) -> dict:
        """probs_gap: the unaries' widest gap over their scale;
        crf_q_gap: the posteriors' widest gap."""
        return {'probs_gap': max(max_gap(got[i][0], ref[i][0]) for i in ref),
                'crf_q_gap': max(float((got[i][1] - ref[i][1]).abs().max())
                                 for i in ref)}
