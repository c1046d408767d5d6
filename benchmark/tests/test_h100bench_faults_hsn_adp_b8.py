"""``hsn_adp_b8``'s whole run (the look for a card skipped) with the timed
path broken underneath reads ``correct`` false, once for each fault: one
pixel's morph posterior altered where it is made, half of the batch left
out, and the direct window cut to radius ceil(2 sxy) of its 3 sxy (a
part of the mathematics left out is no speed-up)."""
import math
import time

import pytest
import torch

from benchmark.harness import runner, spec
from conftest import TINY

BENCH = spec.load_benchmark()
CELL = 'hsn_adp_b8'


def run():
    return runner.run(BENCH, CELL, 2 ** 35 + 11, 0.2, False,
                      torch.device('cpu'), time.time(), TINY[CELL])


def morph_altered(fn):
    """One pixel's morph posterior turned by one class (the morph CRF
    has 1 + 28 classes; the func CRF is left alone)."""
    def broken(probs, img, cfg, *a, **k):
        q = fn(probs, img, cfg, *a, **k)
        if q.shape[-1] == 29:
            q = q.clone()
            q[0, 0, 0] = q[0, 0, 0].roll(1)
        return q
    return broken


def half_batch(fn):
    """The first half of the batch filtered, its result given for all."""
    def broken(probs, img, cfg, *a, **k):
        h = max(1, probs.shape[0] // 2)
        q = fn(probs[:h], img[:h], cfg, *a, **k)
        return torch.cat([q] * (probs.shape[0] // h))
    return broken


@pytest.mark.parametrize('fault', [morph_altered, half_batch])
def test_posterior_faults(fault, monkeypatch, torch_threads):
    from wsss_tpu_torch.methods import hsn
    assert TINY[CELL]['traffic']['batch'] >= 2
    monkeypatch.setattr(hsn, 'mean_field', fault(hsn.mean_field))
    assert not run()['correct']


def test_window_cut(monkeypatch, torch_threads):
    """The window's offsets beyond ceil(2 sxy) of the centre left out."""
    from wsss_tpu_torch.ops.crf import meanfield
    init = meanfield.DirectBilateral.__init__
    cut = {}

    def cut_init(self, imgs, sxy, srgb):
        init(self, imgs, sxy, srgb)
        r = math.ceil(2 * sxy)
        keep = [i for i, (dy, dx) in enumerate(self.offs)
                if dy * dy + dx * dx <= r * r]
        cut[sxy] = (len(self.offs), len(keep))
        self.offs = [self.offs[i] for i in keep]
        self.wspace = [self.wspace[i] for i in keep]
    monkeypatch.setattr(meanfield.DirectBilateral, '__init__', cut_init)
    r = run()
    assert cut and all(k < n for n, k in cut.values())
    assert not r['correct'], r['check']
    assert r['check']['crf_q_gap']['value'] > \
        r['check']['crf_q_gap']['limit']
