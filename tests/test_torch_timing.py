"""The port's progress meters and run log against the JAX package's, and
its torch.profiler trace (the JAX package writes a jax.profiler one)."""
import json
import os

import numpy as np
import torch

from wsss_tpu.utils import timing as ref
from wsss_tpu_torch.utils import timing


def test_average_meter_equals_jax():
    ours, theirs = timing.AverageMeter(), ref.AverageMeter()
    for vals in ({'loss': 1.5, 'f1': 0.25}, {'loss': 0.5}, {'loss': 2.0}):
        ours.add(vals)
        theirs.add(vals)
    assert ours.get('f1') == theirs.get('f1') == 0.25
    assert ours.pop('loss') == theirs.pop('loss') == 4.0 / 3
    ours.add({'loss': 3.0})
    theirs.add({'loss': 3.0})
    assert ours.get('loss') == theirs.get('loss') == 3.0


def test_timer_eta_format():
    t = timing.Timer()
    t.update_progress(0.5)
    eta = t.str_estimated_complete()
    assert len(eta.split(':')) == 3 and t.get_stage_elapsed() >= 0
    t.reset_stage()
    assert t.get_stage_elapsed() < 1.0


def test_metrics_logger_lines_read_by_both(tmp_path):
    path = str(tmp_path / 'log' / 'run' / 'train.jsonl')
    log = timing.MetricsLogger(path)
    log.log(1, seed=np.float32(0.5), total=torch.tensor(2.5))
    log.log(2, val_miou=0.125)
    for reader in (log, ref.MetricsLogger(path)):
        rows = reader.read()
        assert [r['step'] for r in rows] == [1, 2]
        assert rows[0]['seed'] == 0.5 and rows[0]['total'] == 2.5
        assert rows[1]['val_miou'] == 0.125
    assert timing.MetricsLogger(str(tmp_path / 'none.jsonl')).read() == []


def test_sync_and_profile_trace(tmp_path):
    assert timing.sync(torch.arange(3.0) + 1) == 1.0
    with timing.profile_trace(None):
        pass
    with timing.profile_trace(str(tmp_path / 'prof')):
        torch.ones(8).sum()
    with open(tmp_path / 'prof' / 'trace.json') as f:
        assert 'traceEvents' in json.load(f)
    assert os.listdir(tmp_path / 'prof') == ['trace.json']
