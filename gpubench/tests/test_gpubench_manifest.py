"""BENCHMARK.json against the benchmark's contract: names and units in
the allowed characters, every file and reader it names present, every
``moves`` and ``workloads`` list consistent, and the chip-time budget of a
full check with 24 cells."""

import json
import re

import pytest

from gpubench.manifest import HERE, ROOT, Manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_.\-/]{1,200}$')
SOURCES = ('device_trace', 'program_span', 'program_counter', 'host_clock')


@pytest.fixture(scope='module')
def bench():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        '\n' not in text and '\t' not in text


def test_top_level(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    assert 1 <= len(bench['paths']) <= 16
    for p in bench['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(bench['command']) <= 32
    assert all(line(w) for w in bench['command'])
    for word in bench['command']:
        if '/' in word:
            assert any(word.startswith(p + '/') for p in bench['paths'])
    rs = bench['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_allowed(bench):
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in bench[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    assert len(metrics) == len(set(metrics))


def test_configs(bench):
    assert 1 <= len(bench['configs']) <= 24
    used = {w['config'] for w in bench['workloads']}
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['name'] in used
        assert line(c['source']) and line(c['why'])
        assert c['file'].startswith('gpubench/')
        data = json.loads((ROOT / c['file']).read_text())
        assert data['name'] == c['name']
        assert data['reduced'] == c['reduced'] and len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
        for key in ('problem', 'shape', 'spacing', 'nbl', 'space_order',
                    'dtype', 'tn', 'layout', 'receivers'):
            assert key in data, key
        assert (HERE / 'solvers' / f"{data['problem']}.py").exists()
        assert (HERE / 'reference' / f"{data['problem']}.py").exists()
        assert (HERE / 'limits' / f"{c['name']}.json").exists()
        assert (HERE / 'roofline' / f"{c['name']}.json").exists()
    files = [c['file'] for c in bench['configs']]
    assert len(files) == len(set(files))


def test_workloads(bench):
    assert 1 <= len(bench['workloads']) <= 24
    configs = {c['name'] for c in bench['configs']}
    pairs = set()
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['config'] in configs and w['chips'] in (1, 4)
        assert NAME.match(w['traffic']) and line(w['why'])
        assert (HERE / 'traffic' / f"{w['traffic']}.json").exists()
        # the mix's job driver, found by name, with its faults
        driver = Manifest.driver(Manifest.traffic(w['traffic']))
        assert callable(driver.Jobs) and driver.FAULTS
        pairs.add((w['config'], w['traffic']))
    assert len(pairs) == len(bench['workloads'])
    four = sum(w['chips'] == 4 for w in bench['workloads'])
    assert four <= max(1, len(bench['workloads']) // 4)


def test_metrics(bench):
    cells = {w['name'] for w in bench['workloads']}
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert 1 <= len(e2e) <= 16 and 'setup_s' in e2e
    assert 1 <= len(bench['per_layer']) <= 128
    for m in bench['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
        assert (HERE / 'endtoend' / f"{m['name']}.py").exists()
    layers = {}
    for m in bench['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in SOURCES and line(m['layer'])
        assert m['moves'] in e2e
        assert (HERE / 'metrics' / f"{m['name']}.py").exists()
        layers.setdefault(m['layer'].lower(), set()).add(m['layer'])
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        for w in m.get('workloads', []):
            assert w in cells
    # one spelling a layer
    assert all(len(v) == 1 for v in layers.values())
    for m in bench['per_layer']:
        # each cell a metric lists reports the metric it moves
        moved = e2e[m['moves']]
        for w in m.get('workloads', cells):
            assert w in moved.get('workloads', cells)
    man = Manifest()
    for w in cells:
        names = {m['name'] for m in man.metrics('end_to_end', w)}
        assert 'setup_s' in names and len(names) >= 2
        assert man.metrics('per_layer', w)


def test_rooflines_and_roofline_names(bench):
    for m in bench['per_layer']:
        if m['name'].endswith('_roofline') or m['name'].endswith('_pct'):
            assert m['unit'] == '%'


def test_readers_load():
    man = Manifest()
    for kind in ('end_to_end', 'per_layer'):
        for m in man.data[kind]:
            assert callable(Manifest.reader(kind, m['name']))
