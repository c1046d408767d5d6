"""The metric arithmetic on hand-made intervals, traces and shapes: the
union of intervals, the attribution of device operations to ranges and
aten ops by their launch, the idle gaps, the readers and the byte bound
of a grid filter."""
import types

import pytest

from benchmark.harness import checks, peaks, runner, spec, trace


@pytest.mark.parametrize('spans,want', [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),             # overlap counted once
    ([(0, 10), (2, 3), (20, 25)], 15.0),    # nested and disjoint
    ([(20, 25), (0, 10)], 15.0),            # any order
    ([(0, 10), (10, 12)], 12.0),            # touching
])
def test_union(spans, want):
    assert trace.union_seconds(spans) == want


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
         'tid': tid}
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


def hand_trace():
    """A window [0, 100) us: a conv op launching k1 (10..30), a CRF
    range launching k2 (40..50) and a memset (50..52), a kernel launched
    on another thread inside the CRF's time (60..70), and a kernel that
    starts before the window (-5..5)."""
    return [
        ev('user_annotation', trace.WINDOW, 0, 100),
        ev('cpu_op', 'aten::convolution', 1, 4),
        ev('cuda_runtime', 'cudaLaunchKernel', 2, 1, corr=1),
        ev('kernel', 'k1', 10, 20, tid=7, corr=1),
        ev('user_annotation', 'crf.mean_field', 30, 20),
        ev('cuda_runtime', 'cudaLaunchKernel', 31, 1, corr=2),
        ev('kernel', 'k2', 40, 10, tid=7, corr=2),
        ev('cuda_runtime', 'cudaMemsetAsync', 33, 1, corr=3),
        ev('gpu_memset', 'Memset', 50, 2, tid=7, corr=3),
        ev('cuda_runtime', 'cudaLaunchKernel', 35, 1, tid=2, corr=4),
        ev('kernel', 'k3', 60, 10, tid=7, corr=4),
        ev('kernel', 'k0', -5, 10, tid=7, corr=99),
        ev('cpu_op', 'aten::add', 34, 1),
    ]


def test_trace_view():
    v = trace.TraceView(hand_trace())
    assert v.window_s == pytest.approx(100e-6)
    # k0 clipped to [0, 5): 5 + 20 + 10 + 2 + 10
    assert v.busy_s == pytest.approx(47e-6)
    assert sorted(o[0] for o in v.in_range('crf.mean_field')) == \
        ['Memset', 'k2']
    assert [o[0] for o in v.under_ops('aten::convolution')] == ['k1']
    assert v.range_count('crf.mean_field') == 1
    b = v.breakdown()
    assert b['device_ops'][0] == ['k1', pytest.approx(20e-6)]
    gaps = dict((n, s) for n, s in b['idle_gaps'])
    # idle: [5, 10) and [30, 40) while the host was in... [5,10): no
    # range; [30, 40): the CRF range; [52, 60) and [70, 100): none
    assert gaps['crf.mean_field'] == pytest.approx(10e-6)
    assert gaps['host.other'] == pytest.approx((5 + 8 + 30) * 1e-6)


def test_readers_on_the_hand_trace():
    v = trace.TraceView(hand_trace())
    run = {'images': 2, 'calls': 1, 'flops_per_image': 1e6,
           'conv_flops_per_image': 5e5,
           'counters': {'grid.filter_bytes': 3.35e6,
                        'grid.filter_calls': 0}}
    mfu = spec.metric('step.mfu').read(v, run)
    assert mfu == pytest.approx(100 * 2e6 / 100e-6 / peaks.FP32_FLOPS)
    conv = spec.metric('networks.conv_roofline').read(v, run)
    assert conv == pytest.approx(100 * 1e6 / 20e-6 / peaks.FP32_FLOPS)
    idle = spec.metric('device.idle_share').read(v, run)
    assert idle == pytest.approx(53.0)
    assert spec.metric('crf.launches').read(v, run) == 2
    assert spec.metric('crf.device_ms').read(v, run) == pytest.approx(0.012)
    # no grid.filter range in the trace: the reader reads nothing
    assert spec.metric('grid.filter_roofline').read(v, run) is None
    # latency_p95_ms: inclusive quantiles, 0.95 of the way from 10 ms to
    # 200 ms
    lat = [0.01 * k for k in range(1, 21)]
    assert 1e3 * runner.p95(lat) == pytest.approx(190.5)


def test_grid_filter_roofline_reader():
    events = hand_trace() + [ev('user_annotation', 'grid.filter', 32, 5)]
    v = trace.TraceView(events)
    run = {'counters': {'grid.filter_bytes': 3.35e3,
                        'grid.filter_calls': 1}}
    # 3.35 kB at 3.35 TB/s = 1 ns against the memset launched at 33 us
    # (k2 was launched at 31, before the range; k3 on another thread)
    got = spec.metric('grid.filter_roofline').read(v, run)
    assert got == pytest.approx(100 * 1e-9 / 2e-6)


def test_grid_filter_bytes():
    counters = {'grid.filter_bytes': 0.0, 'grid.filter_calls': 0.0}
    obs = checks.grid_filter_counter(counters)
    grid = types.SimpleNamespace(bhw=(8, 64, 64))
    x = types.SimpleNamespace(numel=lambda: 8 * 64 * 64 * 21)
    obs((grid, x), {}, x)
    # input and output of C 21, the RGB guide, float32
    assert counters['grid.filter_bytes'] == 4 * 8 * 64 * 64 * (21 + 21 + 3)
    assert counters['grid.filter_calls'] == 1


def test_leaf_norm_gap():
    import torch
    ref = [torch.ones(4), torch.full((4,), 2.0), torch.full((4,), 1e-6)]
    got = [torch.ones(4), torch.full((4,), 2.2), torch.full((4,), 2e-6)]
    # leaf 1: 0.4 / 4; leaf 2 against the median leaf's norm: 2e-6 / 2
    assert checks.leaf_norm_gap(got, ref) == pytest.approx(0.1)
    assert checks.leaf_norm_gap(got, ref, [False, True, False]) == \
        pytest.approx(1e-6)

