"""grid.filter_roofline: the least time the traced window's grid filters
could take, the bytes each must move (its input [B, H, W, C] read once,
its float32 RGB guide read once, its output written once; not the grid,
which a fused filter need not store) at the HBM rate, over the device
time of the operations launched inside the ranges around
``MXUBilateralGrid.filter`` (the union of their intervals), in %.
Layer: the grid and its kernels."""
from benchmark.harness import peaks, trace


def read(view, run):
    ops = view.in_range('grid.filter')
    secs = trace.union_seconds([(a, b) for _, a, b, _, _ in ops]) / 1e6
    moved = run['counters'].get('grid.filter_bytes', 0.0)
    calls = run['counters'].get('grid.filter_calls', 0.0)
    if secs <= 0 or not moved or calls != view.range_count('grid.filter'):
        return None
    return 100.0 * moved / peaks.HBM_BYTES / secs
