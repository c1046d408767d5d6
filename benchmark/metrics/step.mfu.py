"""step.mfu: the model FLOPs of the calls completed in the traced window
(the configuration's count: 2 x the conv and dense multiply-adds, the
backward's two products in training), over the window's seconds and the
float32 peak, in %.  Layer: the entry step."""
from benchmark.harness import peaks


def read(view, run):
    if not run['images']:
        return None
    flops = run['flops_per_image'] * run['images']
    return 100.0 * flops / view.window_s / peaks.FP32_FLOPS
