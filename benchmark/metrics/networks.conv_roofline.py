"""networks.conv_roofline: the convolutions' FLOPs of the traced window
(the configuration's count) over the device time of the operations
launched inside ``aten::convolution*`` ops (forward and backward; the
union of their intervals, as cuDNN runs some at once), over the float32
peak, in %.  Layer: the networks on cuDNN."""
from benchmark.harness import peaks, trace


def read(view, run):
    ops = view.under_ops('aten::convolution')
    secs = trace.union_seconds([(a, b) for _, a, b, _, _ in ops]) / 1e6
    if secs <= 0 or not run['images']:
        return None
    flops = run['conv_flops_per_image'] * run['images']
    return 100.0 * flops / secs / peaks.FP32_FLOPS
