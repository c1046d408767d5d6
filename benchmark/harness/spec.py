"""Where the harness finds a cell's parts, by the names in
``BENCHMARK.json``:

  * a configuration's file: the ``file`` of its entry (``configs/``), and
    its FLOP count beside it, ``configs/<config>_flops.py``;
  * a traffic mix: ``workloads/<traffic>.json``, which names the entry
    driver that sends it;
  * an entry driver: ``entries/<entry>.py``;
  * a per-layer metric's reader: ``metrics/<metric>.py``.

A later cell, configuration or metric is new files and new entries in
``BENCHMARK.json``; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f'bad name {name!r}')
    return name


def load_benchmark(path: pathlib.Path = ROOT / 'BENCHMARK.json') -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(items, name: str, what: str) -> dict:
    for it in items:
        if it['name'] == name:
            return it
    raise KeyError(f'no {what} named {name!r} in BENCHMARK.json')


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench['workloads'], name, 'workload')


def config(bench: dict, name: str) -> dict:
    entry = _by_name(bench['configs'], name, 'config')
    with open(ROOT / entry['file']) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(BENCH_DIR / 'workloads' / f'{_name(name)}.json') as f:
        return json.load(f)


def _load(path: pathlib.Path, modname: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str) -> ModuleType:
    return _load(BENCH_DIR / 'entries' / f'{_name(name)}.py',
                 f'benchmark.entries.{name}')


def metric(name: str) -> ModuleType:
    return _load(BENCH_DIR / 'metrics' / f'{_name(name)}.py',
                 f'benchmark.metrics.{name.replace(".", "_")}')


def flops(config_name: str) -> ModuleType:
    return _load(BENCH_DIR / 'configs' / f'{_name(config_name)}_flops.py',
                 f'benchmark.configs.{config_name}_flops')


def per_layer_of(bench: dict, workload: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    e2e = {m['name'] for m in end_to_end_of(bench, workload)}
    return [m for m in bench['per_layer']
            if workload in m.get('workloads', ())
            or ('workloads' not in m and m['moves'] in e2e)]


def end_to_end_of(bench: dict, workload: str) -> list:
    return [m for m in bench['end_to_end']
            if 'workloads' not in m or workload in m['workloads']]
