"""SEC prediction: ``cli.sec_dsrg.predict_image`` on one uint8 host image
a call at its native size (the network at its input size, the test CRF
at the native size), labels copied back to the host (a closed loop, one
client, as ``cli.sec_dsrg --task predict`` runs a split).

Kept for the check: the FCN's logits (what the predictor's
``predict_logits`` returned) and the CRF's posterior (what the timed
path's ``mean_field`` returned) of the sampled calls."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import spec
from benchmark.harness import traffic as T
from benchmark.harness import weights as W
from benchmark.harness.checks import grid_filter_counter, max_gap
from benchmark.harness.entry import EntryBase
from benchmark.reference import sec as ref_sec
from benchmark.reference.numerics import Numerics


class Entry(EntryBase):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 ranges):
        from wsss_tpu_torch.cli import sec_dsrg as cli
        from wsss_tpu_torch.data import registry
        from wsss_tpu_torch.ops.crf import mxu_grid
        from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor

        super().__init__(cfg, traffic, seed, device)
        self.cli = cli
        self.spec = registry.get(cfg['dataset'])
        shapes = spec.flops(cfg['name']).kernel_shapes(cfg)['fcn']
        self.layers = W.make_layers(shapes, T.sub_seed(seed, 'weights'),
                                    device)
        self.program = SECDSRGPredictor.random(cfg['method'],
                                               cfg['classes'], device=device)
        W.load_into(self.program.net, self.layers)
        ranges.hook(self.program.net, 'net.fcn')
        ranges.wrap(self.program, 'predict_logits', 'net.predict_logits',
                    self._observe(0))
        ranges.wrap(cli, 'mean_field', 'crf.mean_field', self._observe(1))
        ranges.wrap(mxu_grid.MXUBilateralGrid, 'filter', 'grid.filter',
                    grid_filter_counter(ranges.counters))
        self.warm_up()

    def _observe(self, slot: int):
        def observe(args, kwargs, out):
            if self.keeping():
                self.kept.setdefault(self._i, [None, None])[slot] = out
        return observe

    def inputs(self, i: int) -> np.ndarray:
        return super().inputs(i)[0]

    def call(self, i: int, img: np.ndarray) -> int:
        self._i = i
        self.cli.predict_image(self.program, self.spec, self.cfg['method'],
                               img, img.shape[:2],
                               size=self.cfg['input_size']).cpu().numpy()
        return 1

    def reference_outputs(self, mode: str):
        out = {}
        with Numerics(mode, self.device) as num:
            for i in sorted(self.kept):
                img = torch.as_tensor(self.inputs(i)).to(self.device)
                out[i] = ref_sec.predict(num, self.cfg, self.layers,
                                         img.float())
        return out

    def gaps(self, got: dict, ref: dict) -> dict:
        """logits_gap: the FCN logits' widest gap over their scale;
        crf_q_gap: the posteriors' widest gap."""
        return {'logits_gap': max(max_gap(got[i][0], ref[i][0])
                                  for i in ref),
                'crf_q_gap': max(float((got[i][1] - ref[i][1]).abs().max())
                                 for i in ref)}
