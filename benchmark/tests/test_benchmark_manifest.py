"""BENCHMARK.json against the benchmark's contract, and the discovery of
configurations, traffic mixes, metrics and limits by name."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import run

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


@pytest.fixture(scope='module')
def bench():
    return run.manifest()


def test_top_level_keys(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['paths'] == ['benchmark']
    assert bench['command'][1].startswith('benchmark/')
    assert 1 <= bench['run_seconds'] <= 51
    cells = len(bench['workloads'])
    # a full check of 24 cells at this window fits in 43,200 s
    assert ((2 + 14 * 24) * (bench['run_seconds'] + 60) + 24 * 180 + 1200
            <= 43200)
    assert cells <= 24 and len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize('section', ['configs', 'workloads', 'end_to_end',
                                     'per_layer'])
def test_names_and_units(bench, section):
    names = [e['name'] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
            assert e['source'] in SOURCES
        for key in ('why', 'layer', 'source'):
            if key in e and key != 'source' or section == 'configs' \
                    and key == 'source':
                assert 1 <= len(e[key]) <= 200 and '\n' not in e[key]


def test_workloads_name_known_configs_and_traffic(bench):
    configs = {c['name'] for c in bench['configs']}
    pairs = set()
    for w in bench['workloads']:
        assert w['config'] in configs and w['chips'] in (1, 4)
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
        cell, cfg, traffic = run.cell_of(bench, w['name'])
        assert cfg['name'] == w['config']
        assert traffic['loop'] in ('chunked', 'per_step')
    used = {w['config'] for w in bench['workloads']}
    assert used == configs


def test_end_to_end_metrics(bench):
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert 'setup_s' in e2e and 'workloads' not in e2e['setup_s']
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for w in bench['workloads']:
        reported = [m for m in run.metrics_of(bench, w['name'], False)]
        assert len(reported) >= 2


def test_per_layer_metrics_move_a_metric_their_cells_report(bench):
    layers = {}
    for m in bench['per_layer']:
        assert m['moves'] in {e['name'] for e in bench['end_to_end']}
        for cell in m['workloads']:
            reported = {e['name'] for e in run.metrics_of(bench, cell, False)}
            assert m['moves'] in reported, (m['name'], cell)
        layers.setdefault(m['layer'], set()).add(m['name'])
    for w in bench['workloads']:
        assert run.metrics_of(bench, w['name'], True)


def test_every_metric_has_a_reader(bench):
    for m in bench['end_to_end'] + bench['per_layer']:
        assert callable(run.reader(m['name']))


def test_every_config_has_limits_and_a_kind(bench):
    from benchmark import check
    import importlib
    for c in bench['configs']:
        cfg = json.loads((run.ROOT / c['file']).read_text())
        limits = check.load_limits(cfg['name'])
        assert set(check.NAMES) <= set(limits)
        importlib.import_module(f'benchmark.kinds.{cfg["kind"]}')


def test_parked_cells_are_whole_and_not_measured(bench):
    """A parked cell (benchmark/parked.json) is not in BENCHMARK.json, and
    its configuration, traffic, limits and kind are found as a measured
    cell's are, so that a later entry in BENCHMARK.json is all it needs."""
    from benchmark import check
    import importlib
    both = run.manifest(parked=True)
    parked = [w for w in both['workloads'] if w not in bench['workloads']]
    assert parked and not {w['name'] for w in parked} & {
        w['name'] for w in bench['workloads']}
    for w in parked:
        assert NAME.match(w['name']) and 1 <= len(w['why']) <= 200
        cell, cfg, traffic = run.cell_of(both, w['name'])
        assert cfg['name'] == w['config'] and traffic['loop'] == 'chunked'
        assert set(check.NAMES) <= set(check.load_limits(cfg['name']))
        importlib.import_module(f'benchmark.kinds.{cfg["kind"]}')
        with pytest.raises(SystemExit):
            run.cell_of(bench, w['name'])


def test_discovery_by_name_of_added_files(tmp_path, monkeypatch, bench):
    """A configuration, a traffic mix and a metric added as new files and
    new entries are found without an edit to any file that is there."""
    root = tmp_path / 'checkout'
    shutil.copytree(run.ROOT / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    b = dict(bench)
    b['configs'] = bench['configs'] + [dict(
        bench['configs'][0], name='t3_image_copy',
        file='benchmark/configs/t3_image_copy.json')]
    b['workloads'] = bench['workloads'] + [dict(
        bench['workloads'][0], name='t3_image_copy.chunk100',
        config='t3_image_copy', traffic='chunk100')]
    b['per_layer'] = bench['per_layer'] + [dict(
        bench['per_layer'][0], name='steps_seen',
        workloads=['t3_image_copy.chunk100'])]
    cfg = json.loads((root / 'benchmark/configs/t3_image.json').read_text())
    (root / 'benchmark/configs/t3_image_copy.json').write_text(
        json.dumps(dict(cfg, name='t3_image_copy')))
    (root / 'benchmark/traffic/chunk100.json').write_text(json.dumps(
        {'loop': 'chunked', 'chunk': 100, 'batch': 6, 'variants': 1}))
    (root / 'benchmark/metrics/steps_seen.py').write_text(
        'def read(run):\n    return run.window.steps\n')
    (root / 'BENCHMARK.json').write_text(json.dumps(b))
    monkeypatch.setattr(run, 'ROOT', root)
    monkeypatch.setattr(run, 'BENCH', root / 'benchmark')
    found = run.manifest()
    cell, cfg2, traffic = run.cell_of(found, 't3_image_copy.chunk100')
    assert cfg2['name'] == 't3_image_copy' and traffic['chunk'] == 100
    names = [m['name'] for m in run.metrics_of(found,
                                                't3_image_copy.chunk100',
                                                True)]
    assert names == ['steps_seen']
    import types
    fake = types.SimpleNamespace(window=types.SimpleNamespace(steps=17))
    assert run.reader('steps_seen')(fake) == 17
