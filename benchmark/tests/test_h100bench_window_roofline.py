"""``window.filter_roofline`` on a hand-made trace: the configuration's
window FLOPs of the traced images over the device time of the operations
launched inside the program's ``wsss.window.filter`` spans, at the
float32 peak; nothing read without the span; operations launched outside
it are not counted."""
import pytest

from benchmark.harness import peaks, spec, trace
from test_h100bench_arithmetic import ev

READER = spec.metric('window.filter_roofline')


def window_trace(spans=True):
    """A window [0, 100) us: two filter spans [10, 30) and [50, 70), each
    launching one kernel (k1 at [12, 40), k2 at [55, 75)); a kernel
    launched outside them ([80, 95)); k3 launched inside the first span
    on another thread."""
    events = [
        ev('user_annotation', trace.WINDOW, 0, 100),
        ev('cuda_runtime', 'cudaLaunchKernel', 11, 1, corr=1),
        ev('kernel', 'k1', 12, 28, tid=7, corr=1),
        ev('cuda_runtime', 'cudaLaunchKernel', 52, 1, corr=2),
        ev('kernel', 'k2', 55, 20, tid=7, corr=2),
        ev('cuda_runtime', 'cudaLaunchKernel', 75, 1, corr=3),
        ev('kernel', 'k_outside', 80, 15, tid=7, corr=3),
        ev('cuda_runtime', 'cudaLaunchKernel', 20, 1, tid=2, corr=4),
        ev('kernel', 'k3', 85, 5, tid=7, corr=4),
    ]
    if spans:
        events += [ev('user_annotation', 'wsss.window.filter', 10, 20),
                   ev('user_annotation', 'wsss.window.filter', 50, 20)]
    return events


def test_reads_the_work_over_the_window_spans():
    run = {'window_flops_per_image': 1.0e6, 'images': 3}
    got = READER.read(trace.TraceView(window_trace()), run)
    secs = (28 + 20) * 1e-6            # k1 and k2 only
    assert got == pytest.approx(100.0 * 3.0e6 / secs / peaks.FP32_FLOPS)


def test_nothing_without_the_span():
    """The parent's program opens no such span: None, and no raise."""
    run = {'window_flops_per_image': 1.0e6, 'images': 3}
    assert READER.read(trace.TraceView(window_trace(False)), run) is None


def test_nothing_without_the_count():
    view = trace.TraceView(window_trace())
    assert READER.read(view, {'images': 3}) is None
    assert READER.read(view, {'window_flops_per_image': 1.0e6,
                              'images': 0}) is None
