"""The production ALMA drive of bhnerf_tpu_torch (the counterpart of
scripts/drive_alma_production.py): its seeded Apr11-like lightcurve, its
configuration, the fit script's memory-writer child, and a rehearsal of
the whole drive on the host.

The lightcurve file is the reference's byte for byte, and the port's copy
of the fit configuration loads to the reference's RunConfig. The
rehearsal (DRIVE_CPU=1) shrinks what the reference's rehearsal shrinks,
16x16 rays and 2 variants, and further only the tracer's sample counts:
16 samples a ray (ngeo) and 128 fine steps (n_fine) instead of 100 and
8192, so that its 6 host tables take seconds. It runs 300 steps (a
checkpoint every 100), sends leg 1 SIGTERM as soon as checkpoint_100
appears, resumes it and evaluates the chi^2.
"""
import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import yaml

from bhnerf_tpu import config as j_config

from bhnerf_tpu_torch import config
from bhnerf_tpu_torch.scripts import drive_alma_production as prod
from bhnerf_tpu_torch.scripts import fit_alma_lp_apr11_sgra_flare as fit
from _torch_cores import cores_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_drive():
    """scripts/drive_alma_production.py as a module. Importing it sets
    JAX_PLATFORMS and prepends the repository to sys.path: both are put
    back."""
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            'reference_drive_alma_production',
            os.path.join(REPO, 'scripts', 'drive_alma_production.py'))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path


def test_synthetic_csv_is_the_reference_file(tmp_path):
    """make_synthetic_csv writes the reference's file to the last digit:
    seed 11, 2400 samples at 4 s from 9.30 h, the QU loop, the shadow's
    polarization and the 32.2 deg Faraday rotation."""
    prod.make_synthetic_csv(tmp_path / 'port.csv')
    _reference_drive().make_synthetic_csv(tmp_path / 'jax.csv')
    port = (tmp_path / 'port.csv').read_bytes()
    assert port == (tmp_path / 'jax.csv').read_bytes()
    lines = port.decode().splitlines()
    assert lines[0] == ',time,I,Q,U' and len(lines) == 2401


def test_yaml_copy_loads_to_the_reference_config():
    """The port's fit_alma_lp_apr11_sgra_flare.yaml is the JAX package's:
    each package's RunConfig of either file is the same, field by
    field."""
    ref_path = os.path.join(REPO, 'scripts',
                            'fit_alma_lp_apr11_sgra_flare.yaml')
    assert fit.CONFIG_PATH.parent == prod.Path(prod.__file__).parent
    assert yaml.safe_load(fit.CONFIG_PATH.read_text()) == \
        yaml.safe_load(open(ref_path).read())
    port = config.RunConfig.from_yaml(fit.CONFIG_PATH)
    assert port == config.RunConfig.from_yaml(ref_path)
    assert dataclasses.asdict(port) == dataclasses.asdict(
        j_config.RunConfig.from_yaml(ref_path))
    # the production drive keeps the fused path and the chunked loop
    assert port.optimization.fused and port.optimization.scan_chunk == 500


@pytest.mark.parametrize('num_iters,save_period', [(50000, 5000),
                                                   (1500, 500), (400, 133),
                                                   (2, 1)])
def test_production_config(monkeypatch, tmp_path, num_iters, save_period):
    """The reference's settings: num_iters, a checkpoint every
    min(5000, num_iters // 3) steps, the 10-variant ensemble, logs every
    500, batch 6 and the yaml's weight seed 4; 16x16 rays and 2 variants
    under DRIVE_CPU."""
    monkeypatch.delenv('DRIVE_CPU', raising=False)
    cfg = prod.production_config(num_iters, str(tmp_path))
    opt = cfg['optimization']
    assert opt['hparams']['num_iters'] == num_iters
    assert opt['save_period'] == save_period
    assert opt['log_period'] == 500 and opt['batchsize'] == 6
    assert opt['checkpoint_dir'] == str(tmp_path / 'ckpt')
    assert cfg['model']['num_subrays'] == 10
    assert cfg['model']['num_alpha'] == cfg['model']['num_beta'] == 64
    assert config.RunConfig.from_dict(cfg).optimization.hparams.seed == 4
    monkeypatch.setenv('DRIVE_CPU', '1')
    cfg = prod.production_config(num_iters, str(tmp_path))
    assert cfg['model']['num_subrays'] == 2
    assert cfg['model']['num_alpha'] == cfg['model']['num_beta'] == 16


def test_child_device_check(monkeypatch, tmp_path):
    """The fail-fast check reads the child's complete `# torch device:`
    line, the device of its parameters: a child on the wrong device is
    killed."""
    class Child:
        killed = False

        def kill(self):
            self.killed = True

    log = tmp_path / 'leg.log'
    log.write_text('warning\n# torch device: cu')
    child = Child()
    monkeypatch.delenv('DRIVE_CPU', raising=False)
    assert not prod._check_device(log, child)
    log.write_text('warning\n# torch device: cuda:0\n')
    assert prod._check_device(log, child) and not child.killed
    log.write_text('# torch device: cpu\n')
    with pytest.raises(RuntimeError, match='not on cuda'):
        prod._check_device(log, child)
    assert child.killed
    monkeypatch.setenv('DRIVE_CPU', '1')
    assert prod._check_device(log, Child())


def test_fit_main_memory_writer(monkeypatch, capsys):
    """--writer memory hands the sweep MemoryWriter without tensorboardX,
    --ngeo/--n_fine reach the trace as model overrides, and the script
    ends with its kernel launches."""
    from bhnerf_tpu_torch.train.logging import MemoryWriter
    calls = []
    monkeypatch.setattr(fit, 'run_sweep',
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setitem(sys.modules, 'tensorboardX', None)
    monkeypatch.setenv('DRIVE_CPU', '1')
    fit.main(['60', '--writer', 'memory', '--ngeo', '16', '--n_fine',
              '256'])
    (args, kw), = calls
    assert args[3] is MemoryWriter
    assert kw == dict(resume=False, device='cpu',
                      model_overrides={'ngeo': 16, 'n_fine': 256})
    out = capsys.readouterr().out
    counts = prod._launches(out)
    assert set(counts) == {'render_fwd', 'render_bwd', 'trace_rays'}


def test_drive_rehearsal(monkeypatch, tmp_path):
    """The whole drive on the host: leg 1 is stopped by SIGTERM after its
    first periodic checkpoint at a checkpoint below 300, leg 2 says
    `# resume: ... from step <that step>` and finishes at checkpoint_300,
    and the chi^2 over a fresh 2-variant ensemble are finite. The result
    line carries the reference's keys."""
    monkeypatch.setenv('DRIVE_CPU', '1')
    lines = []
    result, evaluation = prod.drive(300, str(tmp_path), ngeo=16, n_fine=128,
                                    log=lines.append)
    stop = result['interrupt_step']
    assert stop in (100, 200)
    assert any(f'# leg1: SIGTERM at step {stop}' in line for line in lines)
    assert any(f'from step {stop}, {300 - stop} remaining' in line
               and 'finished at checkpoint_300' in line for line in lines)
    for key in ('metric', 'num_iters', 'ensemble', 'batchsize', 'wall_s',
                'interrupt_step', 'chi2_train', 'chi2_val',
                'steps_per_sec_effective', 'ok'):
        assert key in result, key
    assert result['ok'] and result['ensemble'] == 2
    assert np.isfinite([result['chi2_train'], result['chi2_val']]).all()
    assert result['chi2_train'] > 0 and result['chi2_val'] > 0
    assert result['tracer'] == {'ngeo': 16, 'n_fine': 128}
    assert len(evaluation['raytracing_args']) == 2
    json.dumps(result)
    run = tmp_path / 'ckpt' / 'inc_60.0.seed_4'
    assert (run / 'checkpoint_300').is_dir()
    leg1 = (tmp_path / 'fit_leg1.log').read_text()
    assert '# torch device: cpu' in leg1 and '# launches:' in leg1
