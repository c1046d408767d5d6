"""window.filter_roofline: the least time the traced window's direct-window
filters could take, the work the configuration counts for them
(``window_flops_per_image``: 2 C FLOPs per offset, pixel and filter of C
channels, and each colour weight once per CRF) at the float32 peak, over
the device time of the operations launched inside the program's
``wsss.window.filter`` spans (the union of their intervals), in %.  The
same work is counted whatever implements the window.  Layer: the CRF
window."""
from benchmark.harness import peaks, trace


def read(view, run):
    if not view.range_count('wsss.window.filter'):
        return None
    ops = view.in_range('wsss.window.filter')
    secs = trace.union_seconds([(a, b) for _, a, b, _, _ in ops]) / 1e6
    flops = run.get('window_flops_per_image', 0) * run['images']
    if secs <= 0 or not flops:
        return None
    return 100.0 * flops / secs / peaks.FP32_FLOPS
