"""The chi^2(inclination) example of bhnerf_tpu_torch
(examples/recovery_analysis_chi2_grid.py's counterpart) in its small
mode, cut further: 8x8 rays, 8 frames, 3 steps a fit, and every trace at
TRACE (the example traces at trace_geodesics' defaults, which the port's
host loop cannot afford here: trace_geodesics is patched for the call).
"""
import numpy as np

from bhnerf_tpu_torch import alma
from bhnerf_tpu_torch.examples import recovery_analysis_chi2_grid as chi2_grid
from bhnerf_tpu_torch.geodesics import dataset

TRACE = dict(ngeo=16, n_fine=256)


def _forced(fn, **fixed):
    return lambda *args, **kwargs: fn(*args, **{**kwargs, **fixed})


def test_chi2_grid_small_mode(monkeypatch, tmp_path):
    """The chi^2 example's small mode with its tables from the device
    tracer (its plain version on the CPU), at 8x8 rays, 8 frames and 3
    steps a fit: a finite chi^2 table indexed by the reference's
    inclinations, one column a seed."""
    monkeypatch.setitem(chi2_grid.CONFIGS, 'small', dict(
        chi2_grid.CONFIGS['small'], num_iters=3, npix=8, nt=8))
    # the port's alma binds its own name for the one-trace ensemble
    for module in (dataset, alma):
        monkeypatch.setattr(module, 'trace_geodesics',
                            _forced(module.trace_geodesics, **TRACE))
    df = chi2_grid.main(str(tmp_path), small=True, device_geos=True,
                        device='cpu')
    assert df.index.name == 'inc'
    assert list(df.index) == [45.0, 60.0, 75.0]
    assert list(df.columns) == ['seed 1']
    assert np.isfinite(df.values).all() and (df.values > 0).all()
    assert (tmp_path / 'chi2_grid' / 'inc60.0' / 'seed1' /
            'checkpoint_3').exists()
