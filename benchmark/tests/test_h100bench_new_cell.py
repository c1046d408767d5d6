"""A cell comes in by new files and new entries in ``BENCHMARK.json``
alone.  In a copy of the benchmark, with ``spec`` pointed at it, a
throwaway cell (``cues_voc_b8``'s traffic and CPU size under new names)
is found part by part, keeps the contract's rules, reports its metrics
and runs correct at its CPU size; without its size file, the lookup names
the file to add."""
import json
import pathlib
import re
import shutil
import time

import pytest
import torch

import test_h100bench_names as names
from benchmark.harness import runner, spec
from conftest import TINY, CpuSizes, MissingSize

CELL, TRAFFIC, LIKE = 'cues_copy_b8', 'cues_copy_b8_321', 'cues_voc_b8'
LISTS = ('img_per_s', 'step.mfu', 'device.idle_share',
         'networks.conv_roofline')
REPO = spec.ROOT


def files(root: pathlib.Path) -> dict:
    """The benchmark's files under ``root``, by their path from it."""
    found = [root / 'BENCHMARK.json', *(root / 'benchmark').rglob('*')]
    return {p.relative_to(root): p.read_bytes() for p in found
            if p.is_file() and '__pycache__' not in p.parts}


def add_cell(tmp_path, monkeypatch, with_size=True) -> dict:
    """Copies the benchmark and ``BENCHMARK.json`` to ``tmp_path``, adds
    the throwaway cell there, points ``spec`` at the copy and returns the
    copy's ``BENCHMARK.json``."""
    bench_dir = tmp_path / 'benchmark'
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(spec.ROOT / 'BENCHMARK.json', tmp_path)
    bench = spec.load_benchmark(tmp_path / 'BENCHMARK.json')
    like = spec.cell(bench, LIKE)

    shutil.copy(bench_dir / 'workloads' / f'{like["traffic"]}.json',
                bench_dir / 'workloads' / f'{TRAFFIC}.json')
    if with_size:
        shutil.copy(bench_dir / 'tests' / 'cpu_sizes' / f'{LIKE}.json',
                    bench_dir / 'tests' / 'cpu_sizes' / f'{CELL}.json')
    bench['workloads'].append({**like, 'name': CELL, 'traffic': TRAFFIC})
    for m in bench['end_to_end'] + bench['per_layer']:
        if m['name'] in LISTS:
            m['workloads'].append(CELL)
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench, indent=1))

    monkeypatch.setattr(spec, 'BENCH_DIR', bench_dir)
    monkeypatch.setattr(spec, 'ROOT', tmp_path)
    monkeypatch.setattr(names, 'BENCH', bench)
    return bench


def test_a_cell_comes_in_by_new_files(tmp_path, monkeypatch, torch_threads):
    bench = add_cell(tmp_path, monkeypatch)

    c = spec.cell(bench, CELL)
    cfg = spec.config(bench, c['config'])
    traffic = spec.traffic(c['traffic'])
    assert hasattr(spec.entry(traffic['entry']), 'Entry')
    assert spec.flops(c['config']).forward_macs(cfg)['total'] > 0
    e2e = {m['name'] for m in spec.end_to_end_of(bench, CELL)}
    layer = {m['name'] for m in spec.per_layer_of(bench, CELL)}
    assert e2e == {'img_per_s', 'setup_s'}
    assert layer == set(LISTS) - e2e
    assert all(hasattr(spec.metric(m), 'read') for m in layer)
    for rule in (names.test_keys_and_size, names.test_names_units_and_text,
                 names.test_paths_hold_the_command_and_every_file,
                 names.test_configs_match_their_files,
                 names.test_cells_find_their_parts, names.test_metrics,
                 names.test_the_file_is_json_on_its_own):
        rule()

    sizes = CpuSizes(spec.BENCH_DIR / 'tests' / 'cpu_sizes')
    r = runner.run(bench, CELL, 2 ** 33 + 5, 0.2, False,
                   torch.device('cpu'), time.time(), sizes[CELL])
    assert r['correct'], r['check']
    assert set(r['metrics']) == e2e
    assert r['attempted'] >= 1 and r['failed'] == 0

    old, new = files(REPO), files(tmp_path)
    assert {f for f in old if new[f] != old[f]} == {
        pathlib.Path('BENCHMARK.json')}
    assert set(new) - set(old) == {
        pathlib.Path('benchmark/workloads', f'{TRAFFIC}.json'),
        pathlib.Path('benchmark/tests/cpu_sizes', f'{CELL}.json')}


def test_a_cell_without_its_size_file_names_the_file(tmp_path, monkeypatch):
    add_cell(tmp_path, monkeypatch, with_size=False)
    sizes = CpuSizes(spec.BENCH_DIR / 'tests' / 'cpu_sizes')
    want = re.escape(f'add benchmark/tests/cpu_sizes/{CELL}.json')
    with pytest.raises(MissingSize, match=want):
        sizes[CELL]
    with pytest.raises(MissingSize, match=want):
        TINY[CELL]
