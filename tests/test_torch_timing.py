"""The port's run log against the JAX package's, and its torch.profiler
trace (the JAX package writes a jax.profiler one) over every thread."""
import json
import os

import numpy as np
import torch

from wsss_tpu.utils import timing as ref
from wsss_tpu_torch.parallel import mesh as mesh_mod
from wsss_tpu_torch.utils import timing


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
    with timing.profile_trace(None):
        pass
    with timing.profile_trace(str(tmp_path / 'prof')):
        torch.ones(8).sum()
    with open(tmp_path / 'prof' / 'trace.json') as f:
        assert 'traceEvents' in json.load(f)
    assert os.listdir(tmp_path / 'prof') == ['trace.json']


def test_profile_trace_records_shard_threads(tmp_path):
    """A span opened in a shard's worker thread, made before the profiler
    started, lands in the written trace beside the caller's."""
    mesh = mesh_mod.Mesh([torch.device('cpu')] * 2, ('data',))
    mesh_mod._shard_workers(2).submit(lambda: None).result()
    with timing.profile_trace(str(tmp_path)):
        outs = mesh_mod.run_shards(mesh, lambda i, d: torch.ones(4) * i)
    assert [float(o.sum()) for o in outs] == [0.0, 4.0]
    with open(tmp_path / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    tids = {e['tid'] for e in events if e.get('cat') == 'user_annotation'
            and e['name'] == 'wsss.train.forward'}
    assert len(tids) == 2
