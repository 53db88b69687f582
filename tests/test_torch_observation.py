"""bhnerf_tpu_torch.observation against bhnerf_tpu.observation: the port
carries the numpy module whole, so the same inputs and seeds must give
exactly equal arrays (NaN where the reference has NaN): station tables,
sidereal time, uv coverage, synthesis with every noise tier, the six
chi-square data types with dense and factored operators, the DFT
operators, calibration, flat uv records and padding. EHT2017 array, 6
scans, 12x12 Stokes movies; ngEHT for the tables.
"""
import dataclasses

import numpy as np
import pytest

from bhnerf_tpu import observation as j_obs
from bhnerf_tpu import units as j_units

from bhnerf_tpu_torch import observation as obs
from bhnerf_tpu_torch import units

NT = 6
NPIX = 12
PSIZE = 1e-10
T_HR = np.linspace(4.0, 15.5, NT)
ARRAYS = ('eht_arrays/EHT2017.txt', 'eht_arrays/ngEHT.txt')
DTYPES = ('vis', 'amp', 'cphase', 'bs', 'logcamp', 'camp')


def assert_same(a, b, path='value'):
    """Exactly equal: arrays by dtype and value (NaNs in the same
    places), dataclasses field by field, sequences and dicts item by
    item."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f'{path}.{f.name}')
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f'{path}[{k!r}]')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a is None and b is None), path


def both(fn):
    """fn(observation module, units module) for each package."""
    return fn(obs, units), fn(j_obs, j_units)


def _movie(seed=0, nstokes=3):
    rng = np.random.default_rng(seed)
    movie = rng.random((NT, nstokes, NPIX, NPIX))
    movie[:, 1:] -= 0.5
    return movie


def _empty(lib, path='eht_arrays/EHT2017.txt', nt=NT, **kw):
    return lib.empty_eht_obs(lib.load_txt(path), nt=nt, tint=60.0, **kw)


@pytest.mark.parametrize('path', ARRAYS)
def test_load_txt(path):
    assert_same(*both(lambda lib, u: lib.load_txt(path)))


def test_gmst_hours():
    ut = np.linspace(0.0, 30.0, 41)
    assert_same(*both(lambda lib, u: [lib.gmst_hours(mjd, ut)
                                      for mjd in (57850, 59000.5, 60123)]))


@pytest.mark.parametrize('path,nt,kw', [
    (ARRAYS[0], NT, {}),
    (ARRAYS[1], 4, dict(tstart=2.0, tstop=20.0, elevmin=10.0,
                        elevmax=80.0))])
def test_empty_eht_obs(path, nt, kw):
    assert_same(*both(lambda lib, u: _empty(lib, path, nt, **kw)))


OBSERVE = {
    'thermal': dict(thermal_noise=True, seed=0),
    'noiseless': dict(thermal_noise=False),
    'station gains': dict(station_noise=True, seed=1),
    'd-terms': dict(dterm_noise=True, seed=2),
    'field rotation': dict(frcal=False, seed=3),
    'every tier': dict(station_noise=True, dterm_noise=True, frcal=False,
                       sigmat=0.5, dterm_offset=0.1, seed=4),
    'gain toggles': dict(ampcal=False, phasecal=True, rlgaincal=True,
                         neggains=True, stabilize_scan_amp=False,
                         stabilize_scan_phase=False, seed=5),
}


@pytest.mark.parametrize('tier', list(OBSERVE))
def test_observe_same(tier):
    """Visibilities, flags and the applied Jones tables of every noise
    tier (the seeded draws come in the same order)."""
    assert_same(*both(lambda lib, u: lib.observe_same(
        _movie(), T_HR, PSIZE, _empty(lib), **OBSERVE[tier])))


@pytest.fixture(scope='module')
def observed():
    return both(lambda lib, u: lib.observe_same(
        _movie(), T_HR, PSIZE, _empty(lib), thermal_noise=True, seed=0))


@pytest.mark.parametrize('pol', ['I', ('I', 'Q', 'U')])
@pytest.mark.parametrize('operator', ['dense', 'factored'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_chisqdata(observed, dtype, operator, pol):
    """(target, sigma, A) for every data type and operator, frames given
    as Quantities; the closure types refuse several pols alike."""
    pol = pol if isinstance(pol, str) else list(pol)

    def run(ob, u):
        try:
            return ob.chisqdata(u.Quantity(T_HR[::2], 'hr'), dtype,
                                PSIZE * NPIX, NPIX, pol=pol,
                                operator=operator)
        except ValueError as err:
            return str(err)

    ours, ref = run(observed[0], units), run(observed[1], j_units)
    if isinstance(pol, list) and dtype not in ('vis', 'amp'):
        assert isinstance(ours, str) and ours == ref
    else:
        assert_same(ours, ref)


@pytest.mark.parametrize('fn', ['dft_matrix', 'dft_factors'])
@pytest.mark.parametrize('shape', [(NPIX, NPIX), (8, 14)])
def test_dft_operators(fn, shape):
    ny, nx = shape
    u, v = np.random.default_rng(3).uniform(-8e9, 8e9, (2, 17))
    assert_same(*both(lambda lib, _: getattr(lib, fn)(
        u, v, PSIZE * nx, nx, image_fov_y=PSIZE * ny, image_size_y=ny)))


@pytest.mark.parametrize('terms', [
    {}, dict(gains=False), dict(dterms=False, field_rotation=False)])
def test_calibrate(terms):
    """Undoing the known corruption, fully and in part."""
    def run(lib, u):
        corrupt = lib.observe_same(_movie(), T_HR, PSIZE, _empty(lib),
                                   **OBSERVE['every tier'])
        return corrupt.calibrate(**terms)
    assert_same(*both(run))


def test_from_uvdata_and_padded_obs(observed):
    """Flat records (station names, half of them in flipped order) back
    into an Observation, its tlist, the scan-to-frame map and padded
    per-scan fields."""
    def run(lib, u, src):
        recs = src.tlist()
        names = np.asarray(src.array.names)
        flat = {k: np.concatenate([r[k] for r in recs])
                for k in ('time', 'u', 'v', 'sigma', 't1', 't2', 'vis',
                          'qvis', 'uvis')}
        flip = np.arange(len(flat['time'])) % 2 == 1
        t1 = np.where(flip, flat['t2'], flat['t1'])
        t2 = np.where(flip, flat['t1'], flat['t2'])
        sign = np.where(flip, -1.0, 1.0)
        conj = lambda p: np.where(flip, np.conj(p), p)
        ob = lib.Observation.from_uvdata(
            flat['time'], names[t1], names[t2], flat['u'] * sign,
            flat['v'] * sign, flat['sigma'], vis=conj(flat['vis']),
            qvis=conj(flat['qvis']), uvis=conj(flat['uvis']))
        return (ob, ob.tlist(), ob.scan_frame_assignment(T_HR[::2]),
                [lib.padded_obs(ob, f) for f in ('u', 'v', 'sigma', 'vis')])
    ours = run(obs, units, observed[0])
    ref = run(j_obs, j_units, observed[1])
    assert_same(ours, ref)


def test_jones_machinery(observed):
    """Station angles, feed rotation, Gauss-Markov draws, the Jones
    tables and the corruption and its inverse, debiased amplitudes."""
    def run(lib, u, src):
        rng = np.random.default_rng(7)
        g_R, g_L, d_R, d_L = lib.station_jones(
            src, rng, station_noise=True, dterm_noise=True)
        phi = lib.field_rotation_angles(src)
        corrupt = lib.apply_jones_corruption(src.vis, src.baselines, g_R,
                                             g_L, d_R, d_L, phi=phi)
        return (lib.station_angles(src), phi,
                lib.gauss_markov_series(rng, src.times, 5, 0.3),
                (g_R, g_L, d_R, d_L), corrupt,
                lib.apply_inverse_jones(corrupt, src.baselines, g_R, g_L,
                                        d_R, d_L, phi),
                lib.amp_debias(np.abs(src.vis[..., 0]), src.sigma))
    assert_same(run(obs, units, observed[0]),
                run(j_obs, j_units, observed[1]))


def test_stokes_movie_observe_same():
    def run(lib, u):
        movie = lib.stokes_array_to_ehtim(_movie(8, nstokes=4), T_HR, PSIZE)
        return movie.observe_same(_empty(lib), dterm_noise=True, seed=6)
    assert_same(*both(run))
