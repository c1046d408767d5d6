"""train.step_idle_ms: the device's idle time inside the program's
``wsss.train.step`` spans (the shards' forward and losses, the backward,
the optimizer), per step, in ms; the rest of the window's idle lies
between steps.  Layer: the train step."""
from benchmark.harness import spans


def read(view, run):
    return spans.idle_ms_per(view, 'wsss.train.step', 'wsss.train.step')
