"""The harness's whole run (the look for a card skipped) with the timed
path broken underneath must read ``correct`` false, once for each fault
a cell can have: an answer altered where it is produced, half of the
batch left out, and (training) a step that leaves its state unchanged.
The cells run on one card, so no exchange between cards can be left
out."""
import time

import pytest
import torch

from benchmark.harness import runner, spec
from conftest import TINY

BENCH = spec.load_benchmark()


def run(cell):
    return runner.run(BENCH, cell, 2 ** 35 + 9, 0.2, False,
                      torch.device('cpu'), time.time(), TINY[cell])


def altered(fn):
    """One pixel's posterior turned by one class, where it is made."""
    def broken(probs, img, cfg, *a, **k):
        q = fn(probs, img, cfg, *a, **k).clone()
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


@pytest.mark.parametrize('fault', [altered, half_batch])
def test_hsn_faults(fault, monkeypatch, torch_threads):
    from wsss_tpu_torch.methods import hsn
    monkeypatch.setattr(hsn, 'mean_field', fault(hsn.mean_field))
    assert not run('hsn_voc_b8')['correct']


def cue_altered(fn):
    """One seed pixel's cue moved to another class, where it is made."""
    def broken(fg, bg, *a, **k):
        cues = fn(fg, bg, *a, **k).clone()
        cues[0, 0, 0] = cues[0, 0, 0].roll(1)
        return cues
    return broken


def cue_half_batch(fn):
    """The cues of the first half of the batch, given for all of it."""
    def broken(fg, bg, *a, **k):
        h = max(1, fg.shape[0] // 2)
        cues = fn(fg[:h], bg[:h], *a, **k)
        return torch.cat([cues] * (fg.shape[0] // h))
    return broken


@pytest.mark.parametrize('fault', [cue_altered, cue_half_batch])
def test_cue_faults(fault, monkeypatch, torch_threads):
    from wsss_tpu_torch.ops import cues
    monkeypatch.setattr(cues, 'fgbg_cues', fault(cues.fgbg_cues))
    assert not run('cues_voc_b8')['correct']


def test_sec_train_state_unchanged(monkeypatch, torch_threads):
    from wsss_tpu_torch.train import schedules
    monkeypatch.setattr(schedules.ScheduledSGD, 'step', lambda self: True)
    r = run('sec_train_voc')
    assert not r['correct']
    assert r['check']['change_gap']['value'] == pytest.approx(1.0)


def test_sec_train_half_batch(monkeypatch, torch_threads):
    from wsss_tpu_torch.train.sec_dsrg import SECDSRGTrainer
    step = SECDSRGTrainer.train_step

    def broken(self, *arrays, generator, mesh=None):
        h = max(1, arrays[0].shape[0] // 2)
        return step(self, *(a[:h] for a in arrays), generator=generator,
                    mesh=mesh)
    monkeypatch.setattr(SECDSRGTrainer, 'train_step',
                        lambda self, a, b, c, d, g, mesh=None:
                        broken(self, a, b, c, d, generator=g, mesh=mesh))
    assert not run('sec_train_voc')['correct']
