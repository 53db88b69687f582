"""The check that decides `correct`, driven through the rest of a run at a
size that the CPU holds (the harness's look for a card skipped): the port
as it is passes the limits, and the control and every fault that a
training cell can have fail them."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check, faults, run
from benchmark.tests.conftest import tiny

CELLS = ['t3_image.chunk500', 'alma_lc.ens10.chunk500', 't3_image.per_step']


def drive(workload, args, fault=None):
    bench, cell, cfg, traffic = tiny(workload)
    with (fault() if fault else contextlib.nullcontext()):
        return run.run_cell(bench, cell, cfg, traffic, args,
                            torch.device('cpu'))


@pytest.mark.parametrize('workload', CELLS)
def test_port_passes_the_check(workload, cpu_args):
    result = drive(workload, cpu_args)
    assert result['correct'], result['checks']
    assert list(result)[-1] == 'checks'
    assert result['attempted'] > 0


@pytest.mark.parametrize('fault', sorted(faults.FAULTS))
@pytest.mark.parametrize('workload', CELLS[:2])
def test_faults_fail_the_check(workload, fault, cpu_args):
    result = drive(workload, cpu_args, faults.FAULTS[fault])
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('workload', CELLS[:2])
def test_control_fails_the_check(workload):
    """The reference in TF32 in the program's place fails a limit."""
    import importlib
    bench, cell, cfg, traffic = tiny(workload)
    kind = importlib.import_module(f'benchmark.kinds.{cfg["kind"]}')
    fit = kind.build(cfg, traffic, 2**34 + 3, torch.device('cpu'),
                     lambda name: contextlib.nullcontext())
    record = fit.check_steps()
    fit.free()
    ref = check.reference_steps(fit, record, 'cpu')
    ctl = check.reference_steps(fit, record, 'cpu', 'tf32')
    as_program = dataclasses.replace(record, losses=ctl[0], grad1=ctl[1],
                                     params3=ctl[2])
    values = {**check.step_numbers(fit, as_program, ref),
              **check.table_numbers(fit, record)}
    correct, checks = check.verdict(values, check.load_limits(cfg['name']))
    assert not correct, checks


def test_verdict_reads_missing_and_nan_as_failures():
    limits = {n: {'limit': 1e-3} for n in check.NAMES}
    ok, _ = check.verdict({n: 1e-4 for n in check.NAMES}, limits)
    assert ok
    ok, _ = check.verdict({**{n: 1e-4 for n in check.NAMES},
                           'grad': float('nan')}, limits)
    assert not ok
    limits['tables'] = {'limit': None}
    ok, checks = check.verdict({n: 1e-4 for n in check.NAMES if
                                n != 'tables'}, limits)
    assert ok and checks['tables'] == {'value': None, 'limit': None}


@pytest.mark.cuda
def test_a_short_run_on_the_card(capsys):
    """One short run of the first cell on the card (skips off it)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    rc = run.main(['--workload', 't3_image.chunk500', '--seed', '12345',
                   '--seconds', '2', '--trace', '0'])
    import json
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result['correct']
    assert result['metrics']['train_steps_per_s']['value'] > 0


def _scaled(key, factor):
    def mutate(dense):
        dense[key] = dense[key] * factor
    return mutate


def _evpa_turned(radians):
    def mutate(dense):
        q, u = dense['J'][1].copy(), dense['J'][2].copy()
        c, s = np.cos(2 * radians), np.sin(2 * radians)
        dense['J'][1], dense['J'][2] = c * q - s * u, s * q + c * u
    return mutate


MUTATIONS = [('t3_image.chunk500', 'dtau_scaled', _scaled('dtau', 1.001)),
             ('alma_lc.ens10.chunk500', 'scale', _scaled('J', 1.001)),
             ('alma_lc.ens10.chunk500', 'evpa', _evpa_turned(np.deg2rad(0.5))),
             ('alma_lc.ens10.chunk500', 'doppler', _scaled('g', 1.0005))]


@pytest.mark.parametrize('workload,name,mutate', MUTATIONS,
                         ids=[f'{w}-{n}' for w, n, _ in MUTATIONS])
def test_wrong_ray_constants_fail_the_table_check(workload, name, mutate):
    """Ray constants that the program got wrong by a small amount (a global
    scale, an EVPA turned by half a degree, a Doppler factor off by 5e-4)
    fail `tables` or `tables_p90`, while the port's own pass them."""
    import importlib
    bench, cell, cfg, traffic = tiny(workload)
    kind = importlib.import_module(f'benchmark.kinds.{cfg["kind"]}')
    fit = kind.build(cfg, traffic, 2**35 + 11, torch.device('cpu'),
                     lambda name: contextlib.nullcontext())
    record = fit.check_steps()
    fit.free()
    limits = check.load_limits(cfg['name'])
    sound = check.table_numbers(fit, record)
    assert all(sound[k] <= limits[k]['limit'] for k in sound), sound
    for dense in fit.dense:
        mutate(dense)
    wrong = check.table_numbers(fit, record)
    assert any(wrong[k] > limits[k]['limit'] for k in wrong), wrong
