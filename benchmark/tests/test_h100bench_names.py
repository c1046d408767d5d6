"""BENCHMARK.json keeps to the benchmark's contract: names and units of
the allowed characters, every part found by name, each per-layer
metric's end-to-end metric reported by each of its cells."""
import json
import math
import pathlib
import re

from benchmark.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\t\n]{1,200}$')
KEYS = {
    'top': {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'},
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}
WIDTH = re.compile(r'(hidden|intermediate|latent|state|projection|head)'
                   r'|_dim$|_rank$|expansion|per_tok', re.I)


def test_keys_and_size():
    path = spec.ROOT / 'BENCHMARK.json'
    assert path.stat().st_size <= 64 * 1024
    assert set(BENCH) == KEYS['top']
    for section in ('configs', 'workloads'):
        for e in BENCH[section]:
            assert set(e) == KEYS[section], e
    for section in ('end_to_end', 'per_layer'):
        for m in BENCH[section]:
            assert set(m) - {'workloads'} == KEYS[section], m


def test_names_units_and_text():
    for section in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            assert NAME.match(e['name']), e['name']
            for k in ('why', 'layer'):
                if k in e:
                    assert TEXT.match(e[k]), (e['name'], k)
    for c in BENCH['configs']:
        assert TEXT.match(c['source'])
        assert all(NAME.match(k) for k in c['reduced'])
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for w in BENCH['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4)
    for word in BENCH['command']:
        assert TEXT.match(word)
    assert len(BENCH['command']) <= 32


def test_paths_hold_the_command_and_every_file():
    paths = BENCH['paths']
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r'^[A-Za-z0-9_./-]{1,200}$', p) and '..' not in p
        assert not p.startswith('/')
    inside = lambda f: any(f == p or f.startswith(p + '/') for p in paths)
    assert inside(BENCH['command'][1])
    for c in BENCH['configs']:
        assert inside(c['file']) and (spec.ROOT / c['file']).is_file()
    files = [c['file'] for c in BENCH['configs']]
    assert len(files) == len(set(files))
    for f in (spec.BENCH_DIR).rglob('*'):
        if '__pycache__' in f.parts:
            continue
        rel = f.relative_to(spec.BENCH_DIR)
        assert re.match(r'^[A-Za-z0-9_./-]+$', str(rel)), rel


def test_configs_match_their_files():
    used = {w['config'] for w in BENCH['workloads']}
    for c in BENCH['configs']:
        assert c['name'] in used
        cfg = spec.config(BENCH, c['name'])
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced']
        assert len(c['reduced']) <= 16
        assert not any(WIDTH.search(k) for k in c['reduced'])
        assert spec.flops(c['name']).forward_macs(cfg)['total'] > 0


def test_cells_find_their_parts():
    pairs = set()
    for w in BENCH['workloads']:
        pairs.add((w['config'], w['traffic']))
        t = spec.traffic(w['traffic'])
        assert hasattr(spec.entry(t['entry']), 'Entry')
        assert set(t['limits']) and all(
            math.isfinite(v) and v > 0 for v in t['limits'].values())
    assert len(pairs) == len(BENCH['workloads'])
    four = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert four <= max(1, len(BENCH['workloads']) // 4)


def test_metrics():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and 'workloads' not in e2e['setup_s']
    assert e2e['setup_s']['bound'] <= 0.25
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    cells = {w['name'] for w in BENCH['workloads']}
    for w in cells:
        names = {m['name'] for m in spec.end_to_end_of(BENCH, w)}
        assert 'setup_s' in names and len(names) >= 2
        assert spec.per_layer_of(BENCH, w)
    layers = {}
    for m in BENCH['per_layer']:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert m['moves'] in e2e
        for w in m.get('workloads', cells):
            assert w in cells
            assert m['moves'] in {x['name']
                                  for x in spec.end_to_end_of(BENCH, w)}
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
        assert hasattr(spec.metric(m['name']), 'read')
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_run_seconds_fit_a_full_check():
    rs = BENCH['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_the_file_is_json_on_its_own():
    text = (spec.ROOT / 'BENCHMARK.json').read_text()
    assert json.loads(text) == BENCH
    assert pathlib.Path(spec.ROOT / BENCH['command'][1]).is_file()
