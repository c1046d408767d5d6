"""crf.device_ms: device time of the operations launched inside the range
around the entry's ``mean_field`` (the union of their intervals), per
call, in ms.  Layer: the CRF loop."""
from benchmark.harness import trace


def read(view, run):
    calls = view.range_count('crf.mean_field')
    if not calls:
        return None
    ops = view.in_range('crf.mean_field')
    if not ops:
        return None
    return trace.union_seconds([(a, b) for _, a, b, _, _ in ops]) / 1e3 \
        / calls
