"""Port parity: host geodesics and ray constants of bhnerf_tpu_torch against
bhnerf_tpu, and the port's independence from JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest

from bhnerf_tpu import units as j_units
from bhnerf_tpu.geodesics import image_plane_geos as j_image_plane_geos
from bhnerf_tpu.geodesics.dataset import Geodesics as JGeodesics
from bhnerf_tpu.train import raytracing_args as j_raytracing_args

from bhnerf_tpu_torch import units
from bhnerf_tpu_torch.geodesics.dataset import Geodesics, image_plane_geos
from bhnerf_tpu_torch.train.step import raytracing_args

GEO_KW = dict(spin=0.3, inclination=np.deg2rad(60), alpha_range=(-8, 8),
              beta_range=(-8, 8), ngeo=16, num_alpha=8, num_beta=8,
              n_fine=1024)


@pytest.fixture(scope='module')
def geos_pair():
    return j_image_plane_geos(**GEO_KW), image_plane_geos(**GEO_KW)


@pytest.mark.parametrize('field', ['r', 'theta', 'phi', 't', 'mino', 'dtau',
                                   'pm_r', 'pm_th', 'tau_final', 'lam',
                                   'eta'])
def test_geodesic_tables_match_jax(geos_pair, field):
    """The f64 host tracer reproduces the reference tables: both integrate
    the same RK4 in float64, so they agree to ~1e-12 relative (terminal
    Mino times and momentum signs exactly)."""
    jg, tg = geos_pair
    a, b = np.asarray(getattr(jg, field)), np.asarray(getattr(tg, field))
    assert a.shape == b.shape
    assert a.dtype == b.dtype == np.float64
    scale = np.abs(a).max()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * scale)


def test_geodesics_npz_crosses_packages(geos_pair, tmp_path):
    """Tables saved by either package load in the other unchanged."""
    jg, tg = geos_pair
    tg.save(tmp_path / 'torch.npz')
    jg.save(tmp_path / 'jax.npz')
    from_torch = JGeodesics.load(tmp_path / 'torch.npz')
    from_jax = Geodesics.load(tmp_path / 'jax.npz')
    for f in Geodesics._FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(from_torch, f)),
                                      getattr(tg, f))
        np.testing.assert_array_equal(getattr(from_jax, f),
                                      np.asarray(getattr(jg, f)))
    assert from_jax.spin == jg.spin and from_torch.inc == tg.inc


@pytest.mark.parametrize('field', ['coords', 'Omega', 'g', 'dtau', 'Sigma',
                                   't_geos_rel'])
def test_raytracing_args_leaves_match_jax(geos_pair, field):
    """raytracing_args from the same tables: f32 leaves equal to f32
    rounding. The Doppler factor is computed in f64 by the port and in
    f32 by the reference, hence rtol 1e-5 there."""
    jg, _ = geos_pair
    # the same tables on both sides, so only raytracing_args is compared
    tg = Geodesics(**{f: np.asarray(getattr(jg, f))
                      for f in Geodesics._FIELDS + Geodesics._AUX})
    t_inj = -float(jg.r_o + 4)
    j_rt = j_raytracing_args(jg, jg.keplerian_omega(), t_inj,
                             j_units.Quantity(0.1, 'hr'))
    rt = raytracing_args(tg, tg.keplerian_omega(), t_inj,
                         units.Quantity(0.1, 'hr'), device='cpu')
    a = np.asarray(getattr(j_rt, field))
    b = getattr(rt, field).numpy()
    assert b.dtype == np.float32 and a.shape == b.shape
    rtol = 1e-5 if field == 'g' else 1e-7
    np.testing.assert_allclose(b, a, rtol=rtol, atol=0)
    assert rt.t_start_obs == j_rt.t_start_obs
    assert rt.t_to_M == j_rt.t_to_M


def test_port_imports_without_jax():
    """bhnerf_tpu_torch never imports jax (in a fresh interpreter: this
    process already holds jax through tests/conftest.py)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import sys, bhnerf_tpu_torch, bhnerf_tpu_torch.ops.fused; '
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bhnerf_tpu')))")
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, 'PYTHONPATH': root})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
