"""``BENCHMARK.json`` against its contract, and every cell resolved to its
files: configuration, traffic mix, limits and metric readers."""

import json
import os
import re

import pytest

from perfbench.lib import cell as cells

ROOT = cells.ROOT
BENCH = cells.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
WIDTHS = re.compile(r'(_dim|_rank|hidden|intermediate|latent|state|'
                    r'projection|head|expansion|experts_per_token|channels)')


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'perfbench/run.py']
    assert BENCH['paths'] == ['perfbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) < 64 * 1024


def test_budget_fits_with_24_cells():
    rs = BENCH['run_seconds']
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_bounds():
    names = set()
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for entry in BENCH[group]:
            assert NAME.match(entry['name']), entry['name']
            assert entry['name'] not in names
            names.add(entry['name'])
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
    layers = {}
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e and m['moves'] != 'setup_s'
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        layers.setdefault(m['layer'].lower(), set()).add(m['layer'])
        if m['unit'] == '%' and ('roofline' in m['name']
                                 or 'mfu' in m['name']):
            assert m['better'] == 'higher'
    assert all(len(v) == 1 for v in layers.values())


def test_configs_files_and_reductions():
    for c in BENCH['configs']:
        path = os.path.join(ROOT, c['file'])
        assert c['file'].startswith('perfbench/') and os.path.isfile(path)
        data = json.load(open(path))
        assert data['name'] == c['name'] and data['source']
        assert sorted(data['reduced']) == sorted(c['reduced'])
        assert all(k in data for k in c['reduced'])
        assert not any(WIDTHS.search(k) for k in c['reduced'])
        assert any(w['config'] == c['name'] for w in BENCH['workloads'])


def test_cells():
    pairs = set()
    for w in BENCH['workloads']:
        # the harness runs a cell on one card (run.py refuses others)
        assert w['chips'] == 1 and 1 <= len(w['why']) <= 200
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))


@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
def test_every_cell_resolves(name):
    cell = cells.resolve(name)
    assert cell['mix']['loop'] in ('train', 'serve')
    assert cell['limits']
    reported = {m['name'] for m in cell['end_to_end']}
    assert 'setup_s' in reported and len(reported) >= 2
    assert cell['per_layer']
    for m in cell['per_layer']:
        assert callable(cells.reader(m['name']))


def test_every_metric_reader_is_used():
    files = {f[:-3] for f in os.listdir(os.path.join(cells.HERE, 'metrics'))
             if f.endswith('.py')}
    assert files == {m['name'] for m in BENCH['per_layer']}
