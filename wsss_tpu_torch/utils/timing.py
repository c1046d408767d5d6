"""Progress metering and profiling hooks of the port (counterpart of
``wsss_tpu/utils/timing.py``).

Rebuilds the reference's missing ``misc.pyutils`` (used at
train_irn.py:97-141): AverageMeter and a Timer with images/sec + ETA; a
JSONL run log; and a profiler trace, which the port writes with
``torch.profiler`` (a Chrome trace) where the JAX package writes a
``jax.profiler`` one.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


class AverageMeter:
    """misc.pyutils.AverageMeter (train_irn.py:97,122,135)."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def add(self, values: Dict[str, float]):
        for k, v in values.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
            self._counts[k] = self._counts.get(k, 0) + 1

    def get(self, key: str) -> float:
        return self._sums[key] / max(self._counts[key], 1)

    def pop(self, key: str) -> float:
        v = self.get(key)
        self._sums.pop(key, None)
        self._counts.pop(key, None)
        return v


class Timer:
    """misc.pyutils.Timer (train_irn.py:99,132-141): stage-elapsed time,
    progress fraction, ETA string."""

    def __init__(self):
        self.start = time.time()
        self.stage_start = self.start
        self.progress = 0.0

    def update_progress(self, progress: float):
        self.progress = max(progress, 1e-9)

    def get_stage_elapsed(self) -> float:
        return time.time() - self.stage_start

    def reset_stage(self):
        self.stage_start = time.time()

    def str_estimated_complete(self) -> str:
        elapsed = time.time() - self.start
        remain = elapsed * (1.0 - self.progress) / self.progress
        return time.strftime('%H:%M:%S', time.gmtime(max(remain, 0)))


def sync(x) -> float:
    """Wait for the device work behind ``x`` and return its first element
    as a float (a host fetch)."""
    return float(torch.as_tensor(x).reshape(-1)[0])


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block (CPU, and CUDA where a card is
    present), written to ``log_dir/trace.json`` as a Chrome trace; a no-op
    when log_dir is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class MetricsLogger:
    """Append-only JSONL run log — the structured replacement for the
    reference's TensorBoard scalars and regex-parsed flat logs
    (SURVEY.md §5.5)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)

    def log(self, step: int, **values):
        rec = {'step': step, 'time': time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        with open(self.path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
