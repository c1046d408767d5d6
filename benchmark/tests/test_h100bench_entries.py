"""Each entry against its reference at a tiny size on the CPU, through
the harness's whole run (only the look for a card is skipped), and the
control: the reference in TF32 in the program's place fails a limit.
The card's variants run where a card is."""
import time

import pytest
import torch

from benchmark.harness import runner, spec, trace
from conftest import TINY

BENCH = spec.load_benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]


def run(cell, seed=2 ** 33 + 5, traced=False, device='cpu'):
    return runner.run(BENCH, cell, seed, 0.2, traced, torch.device(device),
                      time.time(), TINY[cell])


@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_correct(cell, torch_threads):
    r = run(cell)
    assert r['correct'], r['check']
    want = {m['name'] for m in spec.end_to_end_of(BENCH, cell)}
    assert set(r['metrics']) == want
    assert r['attempted'] >= 1 and r['failed'] == 0
    assert list(r)[-1] == 'check'
    for c in r['check'].values():
        assert c['value'] <= c['limit']


def test_traced_run_reports_per_layer_metrics(torch_threads):
    r = run('hsn_voc_b8', traced=True)
    assert r['correct'], r['check']
    assert r['attempted'] == TINY['hsn_voc_b8']['traffic']['trace_calls']
    allowed = {m['name'] for m in spec.per_layer_of(BENCH, 'hsn_voc_b8')}
    assert 'step.mfu' in r['metrics'] and set(r['metrics']) <= allowed
    assert set(r['breakdown']) == {'device_ops', 'idle_gaps'}
    assert r['device']['window_s'] > 0


def control_gaps(cell, device, seed=17):
    c = spec.cell(BENCH, cell)
    cfg = {**spec.config(BENCH, c['config']), **TINY[cell]['config']}
    traffic = {**spec.traffic(c['traffic']), **TINY[cell]['traffic']}
    dev = torch.device(device)
    with trace.Ranges(False) as ranges:
        entry = spec.entry(traffic['entry']).Entry(cfg, traffic, seed, dev,
                                                   ranges)
        entry.keep(runner.sample_calls(seed, traffic, 2))
        for i in range(2):
            entry.call(i, entry.inputs(i))
    entry.release()
    ref = entry.reference_outputs('fp32')
    return (entry.gaps(entry.reference_outputs('tf32'), ref),
            traffic['limits'])


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails(cell, torch_threads):
    gaps, limits = control_gaps(cell, 'cpu')
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: TF32 exists only there')
    gaps, limits = control_gaps(cell, 'cuda')
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    r = run(cell, device='cuda')
    assert r['correct'], r['check']
