"""Profiling hooks and the run log of the port (counterpart of
``wsss_tpu/utils/timing.py``).

``span`` marks a stage of the program in a profiler trace, where the
JAX package has no spans; ``profile_trace`` writes such a trace with
``torch.profiler`` (a Chrome trace) where the JAX package writes a
``jax.profiler`` one; ``MetricsLogger`` is the JSONL run log.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

# Every span the program opens, each once per unit of work, never per
# kernel or CRF iteration:
SPANS = (
    'wsss.hsn.segment_batch',   # a segment_batch call (HSN and ADP HSN)
    'wsss.sec.predict_image',   # one image of SEC / DSRG prediction
    'wsss.train.step',          # a training step (step_over_shards)
    'wsss.cues.batch',          # a batch of a cue generator's run
    'wsss.io.to_device',        # a host batch copied to the device
    'wsss.io.to_host',          # a batch's cues copied back to the host
    'wsss.cam',                 # a classifier's forward and Grad-CAM
    'wsss.sec.fcn',             # the FCN's forward in predict_logits
    'wsss.net.atrous',          # a LargeFOV head's fc6 as explicit products
    'wsss.train.forward',       # a shard's forward and losses
    'wsss.train.losses',        # the losses after the network, CRF layer in
    'wsss.train.backward',      # the backward and the gradients' sum
    'wsss.train.optimizer',     # the optimizer's step
    'wsss.mesh.wait',           # a thread waiting on the other shards
    'wsss.crf.mean_field',      # a mean_field call
    'wsss.crf.build',           # its unaries, grids and normalizers
    'wsss.crf.loop',            # its iterations
    'wsss.grid.filter',         # a grid's or the dense kernel's filter
    'wsss.window.filter',  # a direct window's filter, whatever implements it
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range called ``name`` (one of ``SPANS``) around a block
    while a profiler runs, in any thread of the process; else a shared
    context that does nothing, at the cost of one flag read.  The flag is
    torch's Python one: ``torch.autograd._profiler_enabled()`` reads False
    in a thread that existed before the profiler started."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block (CPU, and CUDA where a card is
    present) over every thread, so a mesh's shard threads show their
    spans and operations, written to ``log_dir/trace.json`` as a Chrome
    trace; a no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=acts, experimental_config=every_thread) as prof:
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
