"""The readers of the program's spans (``harness/spans.py``): device idle
inside a span's intervals on a hand-made trace, per call; nothing read
where the program opened no such span; the traced cells report them;
and, on the card, the spans and the device operations on one clock."""
import time

import pytest
import torch

from benchmark.harness import runner, spans, spec, trace
from conftest import TINY
from test_h100bench_arithmetic import ev

BENCH = spec.load_benchmark()
READERS = {'crf.loop_idle_ms': 'hsn_voc_b8',
           'crf.build_idle_ms': 'hsn_voc_b8',
           'train.step_idle_ms': 'sec_train_voc'}


def span_trace():
    """A window [0, 100) us with device work at [10, 30), [40, 50) and
    [60, 70); two CRF calls: the first builds over [5, 35) (10 idle) and
    loops over [35, 80) (25 idle), the second has no device work (build
    [82, 90), loop [90, 95)); two train steps, [0, 20) and [55, 100) on
    another thread (10 + 35 idle)."""
    return [
        ev('user_annotation', trace.WINDOW, 0, 100),
        ev('cuda_runtime', 'cudaLaunchKernel', 6, 1, corr=1),
        ev('kernel', 'k1', 10, 20, tid=7, corr=1),
        ev('cuda_runtime', 'cudaLaunchKernel', 36, 1, corr=2),
        ev('kernel', 'k2', 40, 10, tid=7, corr=2),
        ev('cuda_runtime', 'cudaLaunchKernel', 37, 1, corr=3),
        ev('kernel', 'k3', 60, 10, tid=7, corr=3),
        ev('user_annotation', 'wsss.crf.mean_field', 5, 75),
        ev('user_annotation', 'wsss.crf.build', 5, 30),
        ev('user_annotation', 'wsss.crf.loop', 35, 45),
        ev('user_annotation', 'wsss.crf.mean_field', 81, 14),
        ev('user_annotation', 'wsss.crf.build', 82, 8),
        ev('user_annotation', 'wsss.crf.loop', 90, 5),
        ev('user_annotation', 'wsss.train.step', 0, 20),
        ev('user_annotation', 'wsss.train.step', 55, 45, tid=2),
    ]


@pytest.mark.parametrize('xs,ys,want', [
    ([], [(0, 1)], 0.0),
    ([(0, 10)], [(5, 15)], 5.0),
    ([(0, 10), (20, 30)], [(5, 25)], 10.0),
    ([(0, 10)], [(2, 3), (4, 6), (12, 13)], 3.0),
    ([(0, 10)], [(10, 20)], 0.0),           # touching only
])
def test_overlap(xs, ys, want):
    assert spans.overlap(xs, ys) == want


@pytest.mark.parametrize('name,want_ms', [
    ('crf.loop_idle_ms', (25 + 5) / 2 / 1e3),
    ('crf.build_idle_ms', (10 + 8) / 2 / 1e3),
    ('train.step_idle_ms', (10 + 35) / 2 / 1e3),
])
def test_readers_on_the_span_trace(name, want_ms):
    view = trace.TraceView(span_trace())
    assert spec.metric(name).read(view, {}) == pytest.approx(want_ms)


def test_readers_put_the_device_on_the_host_clock():
    """The span trace with the device's timestamps 8 us early: k1 and k2
    then start 4 us before their launch, so the readers move every span
    4 us earlier onto the device's clock and read the trace as if k3 had
    started at 56."""
    events = span_trace()
    for e in events:
        if e['cat'] == 'kernel':
            e['ts'] -= 8
    view = trace.TraceView(events)
    assert spans.clock_offset(spans.leads(view), 0, 100) == 4
    assert spec.metric('crf.loop_idle_ms').read(view, {}) == \
        pytest.approx((25 + 5) / 2 / 1e3)
    # [0, 20) with [6, 20) busy, [55, 100) with [56, 66) busy
    assert spec.metric('train.step_idle_ms').read(view, {}) == \
        pytest.approx((6 + 35) / 2 / 1e3)


def test_readers_follow_a_drifting_device_clock():
    """Two CRF calls 150 ms apart, the device's clock on the host's at
    the first and 300 us before it at the second: each loop is placed by
    its own neighbourhood, so the first keeps its 2.5 ms of idle (the
    kernel runs over its last 0.5 ms) and the second reads 2 ms."""
    events = [
        ev('user_annotation', trace.WINDOW, 0, 200_000),
        ev('user_annotation', 'wsss.crf.mean_field', 1_000, 4_000),
        ev('user_annotation', 'wsss.crf.loop', 2_000, 3_000),
        ev('cuda_runtime', 'cudaLaunchKernel', 4_500, 1, corr=1),
        ev('kernel', 'k1', 4_500, 1_000, tid=7, corr=1),
        ev('user_annotation', 'wsss.crf.mean_field', 150_000, 4_000),
        ev('user_annotation', 'wsss.crf.loop', 151_000, 3_000),
        ev('cuda_runtime', 'cudaLaunchKernel', 151_000, 1, corr=2),
        ev('kernel', 'k2', 150_700, 1_000, tid=7, corr=2),
    ]
    view = trace.TraceView(events)
    lead = spans.leads(view)
    assert spans.clock_offset(lead, 2_000, 5_000) == 0
    assert spans.clock_offset(lead, 151_000, 154_000) == 300
    assert spec.metric('crf.loop_idle_ms').read(view, {}) == \
        pytest.approx((2.5 + 2.0) / 2)


def test_idle_inside_merges_nested_and_overlapping_spans():
    events = span_trace() + [
        ev('user_annotation', 'wsss.crf.loop', 36, 10),       # nested
        ev('user_annotation', 'wsss.train.step', 15, 10, tid=3)]
    view = trace.TraceView(events)
    assert spans.idle_inside(view, 'wsss.crf.loop') == pytest.approx(30e-6)
    # [0, 25) with [10, 25) busy, and [55, 100) with [60, 70) busy
    assert spans.idle_inside(view, 'wsss.train.step') == \
        pytest.approx((10 + 35) * 1e-6)


@pytest.mark.parametrize('name', sorted(READERS))
def test_readers_read_nothing_without_the_spans(name):
    """The parent's program opens no span: each reader reads None."""
    bare = [e for e in span_trace() if not e['name'].startswith('wsss.')]
    assert spec.metric(name).read(trace.TraceView(bare), {}) is None
    # a loop or build span without its mean_field call is not per call
    no_calls = [e for e in span_trace()
                if e['name'] != 'wsss.crf.mean_field']
    if name.startswith('crf.'):
        assert spec.metric(name).read(trace.TraceView(no_calls),
                                      {}) is None


@pytest.mark.parametrize('cell', sorted(set(READERS.values())))
def test_traced_cells_report_the_span_metrics(cell, torch_threads):
    r = runner.run(BENCH, cell, 2 ** 33 + 9, 0.2, True,
                   torch.device('cpu'), time.time(), TINY[cell])
    assert r['correct'], r['check']
    for name, c in READERS.items():
        if c == cell:
            assert r['metrics'][name]['value'] >= 0.0, name


@pytest.mark.cuda
def test_crf_loop_spans_share_the_device_clock():
    """A traced run of ``hsn_voc_b8`` at its own size: placed on the
    device's clock by the offset of the operations launched in the
    ``NEAR_US`` before it opened, every ``wsss.crf.loop`` span finds each
    operation launched inside it starting after its launch, to within
    0.1 ms (the drift of a clock over a loop, and the lead of the
    operations before it)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    cell = spec.cell(BENCH, 'hsn_voc_b8')
    cfg = spec.config(BENCH, cell['config'])
    traffic = spec.traffic(cell['traffic'])
    dev = torch.device('cuda', 0)
    calls = 16
    with trace.Ranges(True) as ranges:
        entry = spec.entry(traffic['entry']).Entry(cfg, traffic,
                                                   2 ** 33 + 7, dev, ranges)
        view = trace.profile(lambda: [entry.call(i, entry.inputs(i))
                                      for i in range(calls)], dev)
    entry.release()
    lead = spans.leads(view)
    loops = view.ranges['wsss.crf.loop']
    assert len(loops) == calls
    offsets = [spans.clock_offset(lead, a, a) for a, _, _ in loops]
    ops = view.in_range('wsss.crf.loop')
    assert len(ops) >= calls
    raw = placed = 0
    for _, start, _, launch, tid in ops:
        k = [i for i, (a, b, t) in enumerate(loops)
             if t == tid and a <= launch <= b]
        raw += start < launch
        placed += not k or start + offsets[k[0]] < launch - 100.0
    print(f'offsets {min(offsets):.1f}-{max(offsets):.1f} us; '
          f'{raw} of {len(ops)} start before their launch unplaced')
    assert placed == 0
