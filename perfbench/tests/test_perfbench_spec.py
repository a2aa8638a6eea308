"""BENCHMARK.json against the contract's rules that a file can show: names
and units in the allowed characters, every metric's `moves` reported in
each of its cells, and every name backed by its file."""

import json
import re

import pytest

from perfbench.core import spec

BENCH = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


def _metrics():
    return BENCH['end_to_end'] + BENCH['per_layer']


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH['paths'] == ['perfbench']
    assert BENCH['command'] == ['python3', 'perfbench/run.py']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('entry', [e['name'] for e in
                                   BENCH['configs'] + BENCH['workloads']
                                   + _metrics()])
def test_names(entry):
    assert NAME.match(entry), entry


def test_units_sources_and_bounds():
    for m in _metrics():
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert any(m['name'] == 'setup_s' for m in BENCH['end_to_end'])


def test_entries_have_only_their_keys():
    allowed = {'configs': {'name', 'source', 'file', 'reduced', 'why'},
               'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
               'end_to_end': {'name', 'unit', 'better', 'bound', 'source',
                              'workloads'},
               'per_layer': {'name', 'unit', 'better', 'source', 'layer',
                             'moves', 'workloads'}}
    for key, keys in allowed.items():
        for e in BENCH[key]:
            assert set(e) <= keys, (key, e)
            for text in ('why', 'layer', 'source'):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and '\n' not in e[text]


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_every_cell_reports_what_it_needs(cell):
    c = spec.load_cell(cell)
    names = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in names and len(names) >= 2
    assert c.per_layer
    # every per-layer metric listing this cell moves an end-to-end metric
    # this cell reports
    for m in BENCH['per_layer']:
        if cell in m.get('workloads', [cell]):
            assert m['moves'] in names, (m['name'], cell)
    assert c.workload['chips'] == 1
    assert c.limits


def test_every_name_has_its_file():
    for c in BENCH['configs']:
        cfg = json.loads((spec.ROOT / c['file']).read_text())
        assert cfg['name'] == c['name'] and c['file'].startswith('perfbench/')
    for w in BENCH['workloads']:
        assert (spec.ROOT / 'perfbench' / 'traffic'
                / f"{w['traffic']}.json").exists()
        driver = spec.driver(spec.load_cell(w['name']).traffic['kind'])
        assert all(callable(getattr(driver, f))
                   for f in ('run', 'reference', 'numbers'))
    for m in BENCH['per_layer']:
        assert callable(spec.metric_reader(m['name']))
    layers = {m['layer'] for m in BENCH['per_layer']}
    assert layers <= {'host pipeline', 'sampler loop', 'training step',
                      'denoiser', 'kernels', 'whole step', 'device'}


def test_check_budget_fits_the_full_benchmark():
    """2 + 14 runs a cell at run_seconds + 60, 180 s of compile a cell and
    1200 s spare must fit 43,200 s with 24 cells."""
    total = (2 + 14 * 24) * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200
    assert total <= 43200
