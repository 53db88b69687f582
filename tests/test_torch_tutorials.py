"""The five tutorials and the last two examples of bhnerf_tpu_torch, each
main at its --small configuration on the host (device='cpu'), and their
parity with the JAX package's scripts where the result is deterministic.

Every trace of both packages is forced to 16 samples a ray and 256 fine
steps (TRACE): the port's host tracer is a Python loop, and the
tutorials trace at trace_geodesics' defaults. Tolerances: tutorial 2's
movie and its observation's visibilities within 5e-5 of their largest
magnitude (the port's time arithmetic and Doppler factor are float64 on
the host, the reference's float32; the two host tracers agree to 1e-12,
tests/test_torch_geodesics.py; the thermal noise is the same seeded numpy
draw in both); the self-calibration's median visibility errors of the
corrupted and the partly calibrated observation within 1e-6 relative of
the reference's (they are ratios of Jones terms, whatever the movie), the
fully calibrated one below 1e-9 in both. The fits draw their weights and
batches from torch generators, the reference's from JAX keys: they are
held to finite, falling losses (the fit to corrupted visibilities to
finite ones).
"""
import contextlib
import importlib.util
import os
import sys

import numpy as np
import pytest

from bhnerf_tpu import observation as j_observation
from bhnerf_tpu import train as j_train
from bhnerf_tpu.geodesics import dataset as j_dataset

from bhnerf_tpu_torch import alma
from bhnerf_tpu_torch.examples import recovery_animation as ra
from bhnerf_tpu_torch.examples import selfcal_known_corruption as selfcal
from bhnerf_tpu_torch.geodesics import dataset
from bhnerf_tpu_torch.tutorials import (
    tutorial1_kerr_geodesics as t1,
    tutorial2_synthesize_ngeht_observations as t2,
    tutorial3_estimate_emission_image_plane as t3,
    tutorial4_estimate_emission_eht as t4,
    tutorial5_visualize_recovery as t5)
from _torch_cores import cores_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = dict(ngeo=16, n_fine=256)


def _forced(fn, **fixed):
    return lambda *args, **kwargs: fn(*args, **{**kwargs, **fixed})


@pytest.fixture
def small_traces(monkeypatch):
    """Both packages' trace_geodesics at TRACE."""
    for module in (dataset, j_dataset, alma):
        monkeypatch.setattr(module, 'trace_geodesics',
                            _forced(module.trace_geodesics, **TRACE))


def _reference(path):
    """The JAX package's script at `path` (relative to the repository) as
    a module; its sys.path insert is undone."""
    saved = list(sys.path)
    try:
        name = 'reference_' + os.path.basename(path)[:-3]
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, path))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path[:] = saved


@contextlib.contextmanager
def recorded_observations(monkeypatch):
    """Records what the JAX package's observe_same returns."""
    seen = []
    observe = j_observation.observe_same

    def record(*args, **kwargs):
        seen.append(observe(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(j_observation, 'observe_same', record)
    yield seen


def assert_falling(losses):
    """Finite losses whose last tenth is below their first (each step's
    loss is over its own batch of frames)."""
    losses = np.asarray(losses)
    assert np.all(np.isfinite(losses)) and losses.size > 1
    tenth = max(losses.size // 10, 1)
    assert losses[-tenth:].mean() < losses[:tenth].mean()


def test_tutorial1_geodesics(small_traces, tmp_path):
    """Tutorial 1's table: its shape, the prograde ISCO of spin 0.2, t
    along the rays from the observer back, and a shadow of captured
    rays."""
    out = t1.main(str(tmp_path), small=True, device='cpu')
    assert out['shape'] == (16, 16, TRACE['ngeo'])
    assert out['isco'] == pytest.approx(5.3294, abs=1e-4)
    assert out['t_range'][1] == 0.0 and out['t_range'][0] < -1000.0
    assert 0.0 < out['captured'] < 0.5
    assert (tmp_path / 'tutorial1_rays.png').exists()
    assert (tmp_path / 'tutorial1_shadow.png').exists()


def test_tutorial2_matches_jax(small_traces, monkeypatch, tmp_path):
    """Tutorial 2's movie and its ngEHT observation's visibilities against
    the JAX package's tutorial from the same forced traces."""
    out = t2.main(str(tmp_path / 'port'), small=True, device='cpu')
    monkeypatch.chdir(REPO)
    with recorded_observations(monkeypatch) as seen:
        _reference('tutorials/tutorial2_synthesize_ngeht_observations.py'
                   ).main(str(tmp_path / 'ref'), small=True)
    ref = np.load(tmp_path / 'ref' / 'tutorial2_data.npz')
    np.testing.assert_array_equal(out['t_frames'], ref['t_frames'])
    movie, j_movie = out['movie'], ref['movie']
    assert movie.shape == j_movie.shape == (8, 16, 16)
    scale = np.abs(j_movie).max()
    np.testing.assert_allclose(movie, j_movie, rtol=0, atol=5e-5 * scale)
    j_obs = seen[0]
    np.testing.assert_array_equal(out['mask'], j_obs.mask)
    assert out['nscan'] == j_obs.nscan and out['n_valid'] > 0
    m = j_obs.mask
    scale = np.abs(j_obs.vis[m]).max()
    np.testing.assert_allclose(out['vis'][m], j_obs.vis[m], rtol=0,
                               atol=5e-5 * scale)
    assert (tmp_path / 'port' / 'tutorial2_uv.png').exists()


def test_tutorial3_then_tutorial5(small_traces, tmp_path):
    """Tutorial 3 fits with falling losses and checkpoints; tutorial 5
    renders that checkpoint, and the synthetic hotspot where there is
    none: three views of 96x96 finite layers, emission and wireframe
    drawn."""
    out = t3.main(str(tmp_path), small=True, device='cpu')
    assert out['steps'] == 200 and out['launches'] == (0, 0)
    assert_falling(out['losses'])
    assert np.isfinite([out['psnr_3d'], out['corr']]).all()
    assert os.path.isdir(os.path.join(out['checkpoint_dir'],
                                      'checkpoint_200'))
    for directory, source in ((tmp_path, 'checkpoint'),
                              (tmp_path / 'fresh', 'hotspot')):
        rendered = t5.main(str(directory), small=True, device='cpu')
        assert rendered['source'] == source
        assert len(rendered['views']) == 3
        for layers in rendered['views']:
            assert [x.shape for x in layers] == [(96, 96)] * 4
            assert all(np.isfinite(x).all() for x in layers)
            assert layers[0].max() > 0 and layers[2].max() > 0
        assert (directory / 'tutorial5_volume_render.png').exists()


def test_tutorial4_fits(small_traces, tmp_path):
    """Tutorial 4's visibility fit: 200 finite losses that fall."""
    out = t4.main(str(tmp_path), small=True, device='cpu')
    assert out['losses'].shape == (200,) and out['nvis'] > 0
    assert_falling(out['losses'])
    assert np.isfinite(out['psnr_3d'])


def test_recovery_animation(small_traces, tmp_path):
    """recovery_animation's fit (falling losses), its recovered movie, its
    six views and its two GIFs."""
    out = ra.main(str(tmp_path), small=True, device='cpu')
    assert_falling(out['losses'])
    assert out['frames'].shape == out['movie'].shape == (12, 16, 16)
    assert np.isfinite(out['frames']).all() and np.isfinite(
        out['movie_loss'])
    assert len(out['views']) == 6
    assert all(np.isfinite(x).all() and x.shape == (96, 96)
               for layers in out['views'] for x in layers)
    for gif in ('recovery_movie.gif', 'recovery_volume_rotation.gif'):
        assert (tmp_path / gif).exists()


def test_selfcal_matches_jax(small_traces, monkeypatch, tmp_path):
    """The self-calibration example: its median visibility errors against
    the JAX package's (whose run stops at its fits): the corrupted and the
    partly calibrated one within 1e-6 relative, the fully calibrated one
    below 1e-9 in both (round-off, ~3e-16); both fits' finite losses, the
    calibrated one's falling (the corrupted data fit no emission)."""
    out = selfcal.main(str(tmp_path), small=True, device='cpu')

    class Stop(Exception):
        pass

    class NoFits:
        @staticmethod
        def eht(*args, **kwargs):
            raise Stop

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(j_train, 'TrainStep', NoFits)
    with recorded_observations(monkeypatch) as seen:
        with pytest.raises(Stop):
            _reference('examples/selfcal_known_corruption.py').main(
                str(tmp_path / 'ref'), small=True)
    j_ideal, j_corr = seen
    m = j_corr.mask
    ref = j_ideal.vis[m]

    def vis_err(o):
        return np.nanmedian(np.abs(o.vis[m] - ref) / (np.abs(ref) + 1e-9))

    j_errors = {'corrupted': vis_err(j_corr),
                'partial': vis_err(j_corr.calibrate(gains=False)),
                'calibrated': vis_err(j_corr.calibrate())}
    for key in ('corrupted', 'partial'):
        assert out['vis_err'][key] == pytest.approx(j_errors[key], rel=1e-6)
    assert out['vis_err']['calibrated'] < 1e-9
    assert j_errors['calibrated'] < 1e-9
    for losses in out['chi2'].values():
        assert losses.shape == (150,) and np.isfinite(losses).all()
    assert_falling(out['chi2']['calibrated'])
