"""The --small configurations of bhnerf_tpu_torch's lightcurve examples,
end to end on the host: polarized_lightcurve_recovery (16x16 rays, 16
frames, 200 fused 'lc' steps on Q and U) and alma_synthetic_flare (16x16
rays, the fit window cut to 9.33-10.4 h, 250 plain steps at 30 and 60
degrees, the chi^2 of each checkpoint through the fused path); and the
synthetic fit's command line with `--writer memory` (8x8 rays, 6 steps)
and its per-run summary. These trace at trace_geodesics' defaults, which
the port's host loop cannot afford here: every trace is forced to 16
samples a ray and 256 fine steps for the call. The examples' parity with
the JAX package is tests/test_torch_lightcurve_examples.py.
"""
import numpy as np
import pytest

from bhnerf_tpu_torch import alma
from bhnerf_tpu_torch.examples import alma_synthetic_flare as flare
from bhnerf_tpu_torch.examples import polarized_lightcurve_recovery as qu
from bhnerf_tpu_torch.geodesics import dataset
from _torch_cores import cores_per_worker  # noqa: F401 (autouse)

TRACE = dict(ngeo=16, n_fine=256)


@pytest.fixture
def small_traces(monkeypatch):
    """The port's trace_geodesics at TRACE (its alma binds its own name for
    the one-trace ensemble)."""
    for module in (dataset, alma):
        fn = module.trace_geodesics
        monkeypatch.setattr(module, 'trace_geodesics',
                            lambda *a, fn=fn, **k: fn(*a, **{**k, **TRACE}))


def _qu(tmp_path):
    """The Q/U recovery reports a finite correlation and PSNR after its
    200 steps."""
    out = qu.main(small=True, device='cpu')
    assert out['iters'] == 200 and np.isfinite(out['final_loss'])
    assert np.isfinite([out['corr'], out['psnr']]).all()
    assert -1.0 <= out['corr'] <= 1.0


def _flare(tmp_path):
    """The ALMA workflow: its data file, a finite positive chi^2 at each of
    its two inclinations, and each fit's checkpoint and predictor."""
    chi2 = flare.main(str(tmp_path), small=True, device='cpu')
    assert list(chi2) == [30.0, 60.0]
    assert np.isfinite(list(chi2.values())).all()
    assert min(chi2.values()) > 0
    for inc in (30, 60):
        assert (tmp_path / f'alma_inc{inc}' / 'checkpoint_250').is_dir()
        assert (tmp_path / f'alma_inc{inc}' /
                'NeRF_Predictor_params.yml').exists()
    assert (tmp_path / 'alma_synthetic.csv').exists()


@pytest.mark.parametrize('run', [_qu, _flare],
                         ids=['polarized_lightcurve_recovery',
                              'alma_synthetic_flare'])
def test_small_run_end_to_end(small_traces, tmp_path, run):
    run(tmp_path)


def test_synthetic_fit_memory_writer_summary(small_traces, monkeypatch,
                                             tmp_path, capsys):
    """generate_synthetic_lightcurves at 8x8 rays, then
    fit_synthetic_lp_flares' main with --writer memory over 6 chunked
    steps: one `# summary:` line with finite losses, the psnr against the
    flare at its first and last log and a finite chi^2, then the launch
    counts."""
    import json
    import re

    import yaml
    from bhnerf_tpu_torch.scripts import fit_synthetic_lp_flares as fit
    from bhnerf_tpu_torch.scripts import generate_synthetic_lightcurves as gen
    monkeypatch.setenv('DRIVE_CPU', '1')
    out = gen.main(['--num_alpha', '8', '--num_beta', '8', '--nt', '40',
                    '--duration', '2.0', '--out', str(tmp_path / 'data'),
                    '--name', 'hot'])
    raw = yaml.safe_load(fit.CONFIG_PATH.read_text())
    raw['optimization'].update(scan_chunk=3, log_period=3, hparams=dict(
        num_iters=6, lr_init=1e-3, lr_final=1e-4, seed=1))
    (tmp_path / 'recovery.yaml').write_text(yaml.dump(raw))
    fit.main([str(out['yaml']), '60', '--seeds', '1', '--writer', 'memory',
              '--config_path', str(tmp_path / 'recovery.yaml')])
    (kind, summary), (last, counts) = re.findall(
        r'# (summary|launches): (\{.*\})', capsys.readouterr().out)
    assert (kind, last) == ('summary', 'launches')
    summary = json.loads(summary)
    assert summary['run'] == 'inc_60.0.seed_1'
    assert (summary['first_step'], summary['last_step']) == (1, 6)
    assert np.isfinite([summary['log10_loss_first20'],
                        summary['log10_loss_last20'], summary['psnr_first'],
                        summary['psnr'], summary['chi2_train']]).all()
    assert summary['chi2_train'] > 0
    assert set(json.loads(counts)) == {'render_fwd', 'render_bwd',
                                       'trace_rays'}
