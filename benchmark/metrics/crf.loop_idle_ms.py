"""crf.loop_idle_ms: the device's idle time inside the program's
``wsss.crf.loop`` spans (the mean field's iterations), per
``wsss.crf.mean_field`` call, in ms: the host issuing the loop's
operations slower than the device runs them.  Layer: the CRF loop."""
from benchmark.harness import spans


def read(view, run):
    return spans.idle_ms_per(view, 'wsss.crf.loop', 'wsss.crf.mean_field')
