"""Port parity: the float32 device trace of bhnerf_tpu_torch
(`trace_geodesics(backend='device')`) against bhnerf_tpu's
backend='device', and what consumes it: the one-launch sub-pixel
ensemble, `get_raytracing_args` and `chi2_df` with backend='device'.

On the CPU the port's backend='device', device='cpu' runs the tracer
kernel's plain version, a float32 loop of torch ops
(`integrator.trace_rays_plain`); the JAX side runs its own float32 trace
on the CPU. The two are independent float32 implementations of one RK4,
so they are compared with the quantile gate of the reference's device
trace (tests/test_geodesics.py:318-366,
bhnerf_tpu_torch/scripts/drive_device_geos.compare), not bitwise.

Small sizes: 12x12x24 rays at n_fine 2048 for the trace, 16x16x24 for
the lightcurve, 8x8 rays of 16 samples at n_fine 1024 for the ensemble
(the JAX package's ensemble traces at its fixed defaults, so its
trace_geodesics is called at these sizes here).
"""
import contextlib
import functools

import numpy as np
import pytest

import bhnerf_tpu.geodesics as j_geodesics
from bhnerf_tpu import alma as j_alma
from bhnerf_tpu.geodesics import image_plane_geos as j_image_plane_geos

import torch

from bhnerf_tpu_torch import alma, constants, emission, units
from bhnerf_tpu_torch.geodesics import (Geodesics, image_plane_geos,
                                        trace_geodesics)
from bhnerf_tpu_torch.geodesics import integrator
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.parallel import create_mesh
from bhnerf_tpu_torch.scripts.drive_device_geos import (compare,
                                                       compare_phi_signs,
                                                       table)
from bhnerf_tpu_torch.train import state as state_lib

# the spin / inclination envelope of tests/test_geodesics.py:318-320
CASES = [(0.94, 60), (0.5, 20), (0.0, 85)]
GEO_KW = dict(alpha_range=(-8, 8), beta_range=(-8, 8), ngeo=24,
              num_alpha=12, num_beta=12, n_fine=2048)
FIELDS = Geodesics._FIELDS
FOV = 20.0
TRACE = dict(ngeo=16, n_fine=1024)
MODEL = {'spin': 0.0, 'fov_M': FOV, 'z_width': 4.0, 'rmin': 'ISCO',
         'Q_frac': 0.85, 'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
         'Omega_dir': 'cw', 'Omega_frac': 1.0, 'num_alpha': 8,
         'num_beta': 8, 't_start_obs': 9.4, **TRACE}
INC = np.deg2rad(60.0)
SPIN = 0.3
SEED = 5
NUM_VARIANTS = 3


def phi_signs(g, truth, fov):
    """compare_phi_signs of a float32 Geodesics against another trace of
    the same screen: phi under t's bars, the momentum signs equal on every
    sample of the rays of the same terminal Mino time."""
    same = g.tau_final == np.asarray(truth.tau_final)
    return compare_phi_signs(
        g.r, (g.phi, g.pm_r, g.pm_th),
        tuple(np.asarray(getattr(truth, f)) for f in ('phi', 'pm_r', 'pm_th')),
        same, fov)


@pytest.fixture(scope='module', params=CASES,
                ids=[f'spin{s}-inc{i}' for s, i in CASES])
def traces(request):
    """One screen grid traced three ways: the port's host float64 trace,
    the port's float32 device trace (its plain version on the CPU) and the
    JAX package's float32 device trace."""
    spin, inc = request.param
    kw = dict(spin=spin, inclination=np.deg2rad(inc), **GEO_KW)
    return dict(f64=image_plane_geos(**kw),
                f32=image_plane_geos(**kw, backend='device', device='cpu'),
                jax=j_image_plane_geos(**kw, backend='device'))


def test_device_trace_tracks_float64(traces):
    """The float32 trace against the float64 one, with the bars of
    tests/test_geodesics.py:339-366: p90 dr/r < 1e-4, dtheta < 1e-3, |dt|
    < 1e-3, median |dt| < 2e-4, and in the domain r <= 16 of the float32
    radii max |dt| < 1 M, p99 < 1e-2, no divergent re-entry; phi under
    the same bars as t and the momentum signs equal on the rays of the
    same terminal Mino time."""
    q = compare(table(traces['f32']), table(traces['f64']), 16.0)
    assert q['ok'], q
    assert q['median_dt'] < 2e-4, q
    q = phi_signs(traces['f32'], traces['f64'], 16.0)
    assert q['ok'] and q['median_dphi'] < 2e-4, q


def test_device_trace_matches_jax(traces):
    """The same gate against the JAX package's float32 trace, phi and the
    momentum signs with it, and the same terminal Mino time on at least
    95% of the rays (an off-by-one termination would move every sample of
    a ray)."""
    q = compare(table(traces['f32']), table(traces['jax']), 16.0)
    assert q['ok'], q
    q = phi_signs(traces['f32'], traces['jax'], 16.0)
    assert q['ok'] and q['median_dphi'] < 2e-4, q
    same_tau = np.mean(traces['f32'].tau_final
                       == np.asarray(traces['jax'].tau_final))
    assert same_tau >= 0.95, same_tau
    # the screen constants come from the same float32-rounded screen
    for f in ('alpha', 'beta', 'lam', 'eta'):
        np.testing.assert_array_equal(getattr(traces['f32'], f),
                                      np.asarray(getattr(traces['jax'], f)))


def test_device_trace_dtypes_match_jax(traces):
    """The reference's output types (dataset.py:336-365): r, theta, phi
    and the momentum signs in float32, t folded in float64, the screen
    and ray constants in float32; every field has the reference's dtype
    and shape."""
    g, j = traces['f32'], traces['jax']
    for f in FIELDS:
        a, b = getattr(g, f), np.asarray(getattr(j, f))
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f
    assert g.r.dtype == g.theta.dtype == g.phi.dtype == np.float32
    assert g.t.dtype == np.float64
    assert g.tau_final.dtype == g.lam.dtype == np.float32
    assert all(getattr(traces['f64'], f).dtype == np.float64 for f in FIELDS)


def test_device_lightcurve_matches_float64():
    """The criterion for chi^2 scans on device tables
    (tests/test_geodesics.py:369-402): the hotspot lightcurve rendered from
    the float32 table is within 1% of the mean flux of the float64 one."""
    fov = 16.0
    kw = dict(spin=0.2, inclination=np.deg2rad(60),
              alpha_range=(-fov / 2, fov / 2),
              beta_range=(-fov / 2, fov / 2), ngeo=24,
              num_alpha=16, num_beta=16, n_fine=2048)
    g64 = image_plane_geos(**kw)
    g32 = image_plane_geos(**kw, backend='device', device='cpu')
    hs = emission.generate_hotspot(
        resolution=(24, 24, 24), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=6.0, std=0.7,
        r_isco=float(constants.isco_pro(0.2)), fov=fov)
    GM_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    t_frames = units.Quantity(
        np.linspace(0, 150 * GM_hr, 8).astype(np.float32), 'hr')
    t_inj = -float(g64.r_o + fov / 4)
    lcs = [np.asarray(emission.image_plane_dynamics(
        hs, g, float(1 / 6.0 ** 1.5), t_frames, t_injection=t_inj,
        device='cpu')).sum(axis=(-1, -2)) for g in (g64, g32)]
    rel = np.abs(lcs[1] - lcs[0]).max() / np.abs(lcs[0]).mean()
    assert rel < 1e-2, rel


@contextlib.contextmanager
def jax_trace_at(**trace):
    """The JAX package's ensemble traces at its fixed defaults (ngeo 100,
    n_fine 8192); inside this scope its trace_geodesics runs at `trace`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_geodesics, 'trace_geodesics', functools.partial(
            j_geodesics.trace_geodesics, **trace))
        yield


@pytest.fixture(scope='module')
def ensemble():
    """The 3-variant sub-pixel ensemble from one seed: the port's one-trace
    ensemble, the port's per-variant loop and the JAX package's
    ensemble, with each generator's state after the draw."""
    rng = np.random.default_rng(SEED)
    port = alma._trace_subpixel_ensemble(INC, SPIN, MODEL, NUM_VARIANTS, rng,
                                         'device', device='cpu')
    rng_loop = np.random.default_rng(SEED)
    fov = MODEL['fov_M']
    loop = [image_plane_geos(
        SPIN, INC, num_alpha=8, num_beta=8,
        alpha_range=[-fov / 2, fov / 2], beta_range=[-fov / 2, fov / 2],
        randomize_subpixel_rays=True, rng=rng_loop, backend='device',
        device='cpu', **TRACE) for _ in range(NUM_VARIANTS)]
    rng_jax = np.random.default_rng(SEED)
    with jax_trace_at(**TRACE):
        jax = j_alma._trace_subpixel_ensemble(INC, SPIN, MODEL, NUM_VARIANTS,
                                              rng_jax, 'device')
    return dict(port=port, loop=loop, jax=jax, rng=rng, rng_loop=rng_loop,
                rng_jax=rng_jax)


def test_ensemble_matches_jax(ensemble):
    """The port's one-trace ensemble against the JAX package's from one
    numpy seed: exactly the same jittered screens (float32), the generator
    left in the same state, and each variant's table within the gate
    (phi and the momentum signs with it) with the same terminal Mino time
    on >= 95% of the rays."""
    assert ensemble['rng'].bit_generator.state == \
        ensemble['rng_jax'].bit_generator.state
    assert len(ensemble['port']) == len(ensemble['jax']) == NUM_VARIANTS
    for g, j in zip(ensemble['port'], ensemble['jax']):
        for f in ('alpha', 'beta', 'lam', 'eta'):
            np.testing.assert_array_equal(getattr(g, f),
                                          np.asarray(getattr(j, f)))
        assert g.r.shape == (8, 8, TRACE['ngeo'])
        q = compare(table(g), table(j), FOV)
        assert q['ok'], q
        q = phi_signs(g, j, FOV)
        assert q["ok"], q
        assert np.mean(g.tau_final == np.asarray(j.tau_final)) >= 0.95


def test_ensemble_equals_per_variant_loop(ensemble):
    """One trace of the stacked (V, na, nb) screens gives bitwise the
    tables of V separate traces (the rays are independent, and the plain
    loop computes each ray with the same elementwise operations), from
    the same draws of the generator."""
    assert ensemble['rng'].bit_generator.state == \
        ensemble['rng_loop'].bit_generator.state
    for g, h in zip(ensemble['port'], ensemble['loop']):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(h, f),
                                          err_msg=f)
        assert (g.spin, g.inc, g.r_o) == (h.spin, h.inc, h.r_o)


@pytest.fixture(scope='module')
def rt_pair():
    """get_raytracing_args(backend='device') of both packages over the
    3-variant ensemble of one seed (the JAX package's physics in its
    float32, the port's in float64 on its float32 tables)."""
    kw = dict(rot_angle=0.3, num_subpixel_rays=NUM_VARIANTS,
              backend='device')
    port = alma.get_raytracing_args(INC, SPIN, MODEL,
                                    rng=np.random.default_rng(SEED),
                                    device='cpu', **kw)
    with jax_trace_at(**TRACE):
        jax = j_alma.get_raytracing_args(INC, SPIN, MODEL,
                                         rng=np.random.default_rng(SEED),
                                         **kw)
    return port, jax


@pytest.mark.parametrize('field,tol', [('t_geos_rel', 5e-3), ('g', 2e-4),
                                       ('J', 2e-4)])
def test_get_raytracing_args_device_matches_jax(rt_pair, field, tol):
    """The ray constants of the device-traced ensemble, inside the emission
    domain (|coords| <= fov / 2 by the port's float32 table): t_geos_rel to
    5e-3 M absolute, g and J to 2e-4 of their largest in-domain value. The
    two float32 traces differ by ~1e-4 M in t (p90) and the JAX package
    computes the transport physics in float32 where the port does it in
    float64 (ops/gr.py), so they agree to ~1e-5 relative (measured: t
    6e-4 M, g 3e-5, J 2e-5 of the scale)."""
    port, jax = rt_pair
    for p, j in zip(port, jax):
        coords = p.coords.numpy()
        dom = np.sqrt((coords ** 2).sum(0)) <= FOV / 2
        assert dom.sum() > 100
        a = np.asarray(getattr(j, field))
        b = getattr(p, field).numpy()
        assert a.shape == b.shape and b.dtype == np.float32
        diff = np.abs(b - a)[..., dom]
        if field == 't_geos_rel':
            assert diff.max() < tol, diff.max()
        else:
            scale = np.abs(a[..., dom]).max()
            assert diff.max() < tol * scale, (diff.max(), scale)


def test_chi2_df_device_backend_within_one_percent(tmp_path):
    """chi2_df over a saved untrained 8x8 checkpoint traces its table on
    the host (float64) or with backend='device' (float32): the two chi^2
    agree to 1%."""
    pred = NeRFPredictor(scale=FOV / 2, rmax=FOV / 2, z_width=4.0,
                         net_depth=2, net_width=32)
    params = pred.init_params(generator=torch.Generator().manual_seed(0),
                              device='cpu')
    with torch.no_grad():
        # lift the head so the lightcurve is macroscopic
        params.mlp.layers[-1].bias += 6.0
    run = tmp_path / '60.0-1'
    pred.save_params(run)
    state_lib.save_checkpoint(run, state_lib.TrainState.create(
        params, state_lib.make_optimizer(10)), 1)
    t = units.Quantity(np.linspace(9.4, 9.8, 5), 'hr')
    data = np.zeros((5, 3))
    chi2 = {backend: alma.chi2_df(
        [60.0], SPIN, [1], MODEL, str(tmp_path / '{}-{}'), t, data,
        rot_angle=0.3, checkpoint_name='checkpoint_1', backend=backend,
        device='cpu').values[0, 0] for backend in ('cpu', 'device')}
    assert np.isfinite(chi2['cpu']) and chi2['cpu'] > 0
    assert abs(chi2['device'] - chi2['cpu']) < 1e-2 * chi2['cpu'], chi2


def test_backend_errors_and_fillna():
    """The reference's refusals (dataset.py:266-276): an unknown backend
    and float64 on the device backend raise ValueError, and so does a
    mesh with the host backend (dataset.py:289-291); on the device
    backend a mesh of one process traces the table of no mesh.
    Geodesics.fillna returns the table itself (it holds no NaN)."""
    a = np.array([[5.0]])
    b = np.zeros_like(a)
    with pytest.raises(ValueError, match='backend'):
        trace_geodesics(a, b, 0.5, 1.0, backend='gpu')
    with pytest.raises(ValueError, match='float32'):
        trace_geodesics(a, b, 0.5, 1.0, backend='device', dtype=np.float64,
                        device='cpu')
    mesh = create_mesh(device='cpu')
    with pytest.raises(ValueError, match='device'):
        trace_geodesics(a, b, 0.5, 1.0, backend='cpu', mesh=mesh,
                        device='cpu')
    g = trace_geodesics(a, b, 0.5, 1.0, ngeo=4, n_fine=64, backend='device',
                        device='cpu')
    g_mesh = trace_geodesics(a, b, 0.5, 1.0, ngeo=4, n_fine=64,
                             backend='device', device='cpu', mesh=mesh)
    for f in ('r', 'theta', 'phi', 't', 'tau_final'):
        np.testing.assert_array_equal(getattr(g_mesh, f), getattr(g, f))
    assert g.fillna() is g and g.fillna(1.0) is g
    assert np.isfinite(g.r).all()


def test_cpu_tensors_take_the_plain_version():
    """trace_rays on CPU tensors runs trace_rays_plain (the same numbers)
    and leaves the kernel's launch counter still; the host float64 trace
    goes the same way."""
    state0, lam, eta = integrator.initial_state(
        np.array([4.0, 6.0, -3.0]), np.array([0.5, -2.0, 1.0]), 0.5, 1.0,
        1000.0, torch.float32)
    before = integrator.trace_rays.launches
    kw = dict(r_o=1000.0, n_fine=256, ngeo=6)
    tau, samples = integrator.trace_rays(state0, 0.5, lam, eta, **kw)
    tau_p, samples_p = integrator.trace_rays_plain(state0, 0.5, lam, eta,
                                                   **kw)
    assert integrator.trace_rays.launches == before
    assert torch.equal(tau, tau_p)
    assert set(samples) == set(integrator.SAMPLE_FIELDS)
    for k in samples:
        assert samples[k].shape == (6, 3) and samples[k].dtype == torch.float32
        assert torch.equal(samples[k], samples_p[k]), k
    trace_geodesics(np.array([5.0]), np.array([0.0]), 0.5, 1.0, ngeo=4,
                    n_fine=64)
    assert integrator.trace_rays.launches == before
