"""HistoSegNet on ADP: ``ADPHSNSegmenter(handle, 'X1.7')``'s
``segment_batch`` on host batches of uint8 images, both label maps copied
back to the host after each batch (a closed loop, one client, as
``cli.hsn --dataset ADP-morph --model X1.7`` runs a split).

The traffic's ``white_cols`` first columns of every pool image are set
to 250, ADP's glass (mean > 240), so the synthetic background channel is
not empty.

Kept for the check, for the sampled calls: the unaries and posteriors of
the morph and the func CRF, as the timed path's ``mean_field`` received
and returned them.  The reference recomputes the unaries from the same
images and weights (``probs_gap``), and runs its mean field on the
program's own kept unaries (``crf_q_gap``): unaries near the 1e-10 clamp
turn rounding into whole nats, so the posteriors are compared on the
same input, which isolates the window."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import spec
from benchmark.harness.checks import max_gap
from benchmark.harness.entry import EntryBase, classifier_handles
from benchmark.reference import adp_hsn as ref_adp
from benchmark.reference.numerics import Numerics

CRFS = ('crf_morph', 'crf_func')        # in the order segment_batch runs


class Entry(EntryBase):
    reverse_window = False      # the reference sums its offsets backwards

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 ranges):
        from wsss_tpu_torch.methods import hsn
        from wsss_tpu_torch.ops.crf.config import CRFConfig

        super().__init__(cfg, traffic, seed, device)
        for arr in self.pool:
            arr[:, :, :traffic['white_cols']] = 250
        layers, (handle,) = classifier_handles(cfg, seed, device, ranges,
                                               cfg['class_threshold'])
        (self.layers,) = layers.values()
        self.program = hsn.ADPHSNSegmenter(
            handle, cfg['model_tag'],
            cfg_morph=CRFConfig(**cfg['crf_morph']),
            cfg_func=CRFConfig(**cfg['crf_func']), device=device)
        ranges.wrap(hsn, 'mean_field', 'crf.mean_field', self._observe)
        self.warm_up()

    def _observe(self, args, kwargs, q):
        if self.keeping():
            self.kept.setdefault(self._i, []).append((args[0], q))

    def call(self, i: int, batch: np.ndarray) -> int:
        self._i = i
        morph, func = self.program.segment_batch(batch)
        morph.cpu().numpy()
        func.cpu().numpy()
        return batch.shape[0]

    def work(self) -> dict:
        out = super().work()
        out['window_flops_per_image'] = spec.flops(
            self.cfg['name']).window_flops(self.cfg)
        return out

    def reference_outputs(self, mode: str):
        """{call: [(unaries, posterior) of each CRF]}: the unaries from
        the images, the posteriors from the program's kept unaries."""
        out = {}
        with Numerics(mode, self.device) as num:
            ref = ref_adp.ADPHSNReference(num, self.cfg, self.layers)
            for i in sorted(self.kept):
                imgs = torch.as_tensor(self.inputs(i)).to(self.device)
                probs = ref.probs(imgs.float())
                out[i] = [(p, ref.crf(key, kept_p, imgs,
                                      self.reverse_window))
                          for p, key, (kept_p, _) in zip(probs, CRFS,
                                                         self.kept[i])]
        return out

    def gaps(self, got: dict, ref: dict) -> dict:
        """probs_gap: both CRFs' unaries, the widest gap over their
        maximum; crf_q_gap: both posteriors, the widest gap."""
        pairs = [(g, r) for i in ref for g, r in zip(got[i], ref[i])]
        return {'probs_gap': max(max_gap(g[0], r[0]) for g, r in pairs),
                'crf_q_gap': max(float((g[1] - r[1]).abs().max())
                                 for g, r in pairs)}
