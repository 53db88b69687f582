"""bhnerf_tpu_torch.visualization against bhnerf_tpu.visualization on the
CPU: the two volume compositors (_vv_composite for every pair of overlay
flags, _transfer_composite), their jnp.interp counterpart,
VolumeVisualizer.render and ipyvolume_3d, and the artist data of the
matplotlib functions on the same inputs; and the completeness of the
port: every public top-level def and class of every module of the JAX
package has its counterpart, apart from ROADMAP's "Do not port" names.

Tolerances: each compositor output within 2e-4 of its maximum (float32
on both sides; the trilinear gathers and the cumprod sum in another
order), the RGB images within 2e-4, the matplotlib data exactly. The
compositor cases give both packages the same camera rays and sample
positions: jnp.linspace rounds a float32 sample position up to an ulp
away from numpy's, and in a volume that is opaque at its first sample
that moves the emission by 4e-4 of its maximum. The renders each build
their own.
"""
import ast
import importlib
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import matplotlib

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402
import torch  # noqa: E402

from bhnerf_tpu import visualization as j_vis  # noqa: E402
from bhnerf_tpu.geodesics.dataset import Geodesics as JGeodesics  # noqa
from bhnerf_tpu_torch import visualization as vis  # noqa: E402
from bhnerf_tpu_torch.geodesics.dataset import Geodesics  # noqa: E402
from _torch_cores import cores_per_worker  # noqa: F401,E402 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 2e-4
EXTENT = 8.0
SAMPLES = 48
RES = (32, 32)
# ROADMAP.md, Queue A, "Do not port": TPU-only machinery
DO_NOT_PORT = {'max_folded_frames', 'unpack_grads', 'frame_sharding',
               'ray_sharding_spec', 'replicated', 'compilation_cache_dir'}


def volume(seed=0, n=24):
    """A seeded emission volume, dense enough at sigma 300 that most rays
    are opaque before they leave the cube."""
    return np.random.default_rng(seed).random((n,) * 3).astype(np.float32)


def thin_volume(seed=1, n=24):
    """A seeded hotspot-like volume: a Gaussian blob times noise, thin
    enough that the BH sphere and the far cube edges show through."""
    g = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(g, g, g, indexing='ij')
    blob = np.exp(-((x - 0.3) ** 2 + y ** 2 + (z * 3) ** 2) / 0.05)
    noise = np.random.default_rng(seed).random((n,) * 3)
    return (0.05 * blob * noise).astype(np.float32)


def close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.all(np.isfinite(port))
    scale = np.abs(ref).max()
    if scale == 0:
        assert np.abs(port).max() == 0
    else:
        np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def camera(azimuth=0.3, zenith=np.pi / 3, resolution=RES, fov=35.0):
    """The port's rays and sample positions as float32 tensors, and the
    same values as JAX arrays."""
    vv = vis.VolumeVisualizer(resolution=resolution, fov=fov,
                              samples=SAMPLES, device='cpu')
    distance = 3.0 * EXTENT
    cam, dirs = vv._rays(azimuth, zenith, distance)
    t_near, t_far = distance - 1.8 * EXTENT, distance + 1.8 * EXTENT
    ts = torch.as_tensor(np.linspace(t_near, t_far, SAMPLES).astype(
        np.float32))
    dt = (t_far - t_near) / SAMPLES
    port = (cam, dirs, ts)
    return port, tuple(jnp.asarray(x.numpy()) for x in port), dt


@pytest.mark.parametrize('draw_cube', [False, True])
@pytest.mark.parametrize('has_bh', [False, True])
@pytest.mark.parametrize('make_volume', [volume, thin_volume],
                         ids=['dense', 'thin'])
def test_vv_composite_matches_jax(draw_cube, has_bh, make_volume):
    """All four layers (emission, shadow, wireframe, shade) of the
    port's _vv_composite against the JAX package's, on a 24^3 volume, 32x32
    pixels, 48 samples, sigma 300."""
    vol = make_volume()
    (cam, dirs, ts), (jcam, jdirs, jts), dt = camera()
    scalars = (dt, EXTENT, 300.0, 2.0 if has_bh else 0.0, 0.012 * EXTENT,
               0.85)
    port = vis._vv_composite(torch.as_tensor(vol), cam, dirs, ts, *scalars,
                             draw_cube=draw_cube, has_bh=has_bh)
    ref = j_vis._vv_composite(jnp.asarray(vol), jcam, jdirs, jts, *scalars,
                              draw_cube=draw_cube, has_bh=has_bh)
    for p, r in zip(port, ref):
        close(p.numpy(), r)
    if make_volume is thin_volume:
        # the overlays are drawn where their flags ask for them
        assert (float(ref[1].max()) > 0) == has_bh
        assert (float(ref[2].max()) > 0) == draw_cube


@pytest.mark.parametrize('make_volume', [volume, thin_volume],
                         ids=['dense', 'thin'])
def test_transfer_composite_matches_jax(make_volume):
    """_transfer_composite's intensity and alpha against the JAX
    package's, with ipyvolume_3d's default transfer nodes and a vmax above
    the volume's own (a movie's global maximum)."""
    vol = make_volume()
    (cam, dirs, ts), (jcam, jdirs, jts), dt = camera()
    levels, opacities = (0.0, 0.2, 0.7), (0.0, 0.2, 0.3)
    vmax = 1.5 * float(vol.max())
    port = vis._transfer_composite(
        torch.as_tensor(vol), vmax, cam, dirs, ts, dt, EXTENT,
        torch.tensor(levels), torch.tensor(opacities))
    ref = j_vis._transfer_composite(
        jnp.asarray(vol), vmax, jcam, jdirs, jts, dt, EXTENT,
        jnp.asarray(levels, jnp.float32), jnp.asarray(opacities, jnp.float32))
    for p, r in zip(port, ref):
        close(p.numpy(), r)


@pytest.mark.parametrize('xp,fp', [
    ((0.0, 0.2, 0.7), (0.0, 0.2, 0.3)),
    ((-1.0, 0.5, 0.5, 2.0), (3.0, 1.0, 2.0, -1.0)),
    ((0.1, 0.4), (0.7, 0.2))], ids=['ipyvolume', 'repeated-node', 'two'])
def test_interp_matches_jnp(xp, fp):
    """interp at, between, below and above its nodes equals jnp.interp."""
    xp32 = np.asarray(xp, np.float32)
    mids = (xp32[1:] + xp32[:-1]) / 2
    x = np.concatenate([xp32, mids, xp32 - 0.25, xp32 + 0.25,
                        [-10.0, 10.0]]).astype(np.float32)
    port = vis.interp(torch.as_tensor(x), torch.as_tensor(xp32),
                      torch.tensor(fp, dtype=torch.float32))
    ref = jnp.interp(jnp.asarray(x), jnp.asarray(xp32),
                     jnp.asarray(fp, jnp.float32))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    assert port.numpy()[x < xp32[0]] == pytest.approx(fp[0])
    assert port.numpy()[x > xp32[-1]] == pytest.approx(fp[-1])


@pytest.mark.parametrize('draw_cube,bh_radius', [(True, 2.0), (False, None)])
def test_volume_visualizer_render_matches_jax(draw_cube, bh_radius):
    """VolumeVisualizer.render's RGB, each package building its own rays
    and samples, on the thin volume at a camera off every axis."""
    vol = thin_volume()
    kw = dict(extent=EXTENT, azimuth=0.8, zenith=np.pi / 3,
              sigma_scale=300.0, bh_radius=bh_radius, draw_cube=draw_cube)
    port = vis.VolumeVisualizer(RES, fov=35.0, samples=SAMPLES,
                                device='cpu').render(vol, **kw)
    ref = j_vis.VolumeVisualizer(RES, fov=35.0, samples=SAMPLES).render(
        vol, **kw)
    assert port.shape == RES + (3,)
    close(port, ref)


def test_ipyvolume_3d_matches_jax(tmp_path):
    """ipyvolume_3d: the 3D volume's RGB; a 4D movie's frame count (its
    GIF) and frames under one normalisation (the halved second frame
    renders dimmer, and each frame equals the reference's)."""
    vol = thin_volume()
    kw = dict(fov=2 * EXTENT, resolution=RES, samples=SAMPLES)
    _, rgb = vis.ipyvolume_3d(vol, device='cpu', **kw)
    _, j_rgb = j_vis.ipyvolume_3d(vol, **kw)
    close(rgb, j_rgb)
    plt.close('all')

    movie = np.stack([vol, 0.5 * vol, 0.25 * vol])
    anim = vis.ipyvolume_3d(movie, device='cpu',
                            output=str(tmp_path / 'port.gif'), **kw)
    j_anim = j_vis.ipyvolume_3d(movie, output=str(tmp_path / 'ref.gif'),
                                **kw)
    from PIL import Image
    with Image.open(tmp_path / 'port.gif') as gif:
        assert gif.n_frames == 3
    frames = [np.asarray(anim._func(i)[0].get_array()) for i in range(3)]
    j_frames = [np.asarray(j_anim._func(i)[0].get_array())
                for i in range(3)]
    for f, jf in zip(frames, j_frames):
        close(f, jf)
    assert frames[0].sum() > frames[1].sum() > frames[2].sum()
    plt.close('all')


def test_compositors_on_a_volume_axis_of_length_one():
    """A volume with an axis of length 1 (an image coordinate of 0 along
    it everywhere on the mid-plane) composites as in the reference."""
    vol = thin_volume()[:, :, 12:13].copy()
    (cam, dirs, ts), (jcam, jdirs, jts), dt = camera()
    scalars = (dt, EXTENT, 300.0, 2.0, 0.012 * EXTENT, 0.85)
    port = vis._vv_composite(torch.as_tensor(vol), cam, dirs, ts, *scalars,
                             draw_cube=True, has_bh=True)
    ref = j_vis._vv_composite(jnp.asarray(vol), jcam, jdirs, jts, *scalars,
                              draw_cube=True, has_bh=True)
    for p, r in zip(port, ref):
        close(p.numpy(), r)


def movies(nt=5, n=6):
    rng = np.random.default_rng(3)
    return rng.random((nt, n, n)), rng.random((nt, n, n))


@pytest.mark.parametrize('scale', ['amp', 'log'])
def test_slider_frame_comparison_update(scale):
    """slider_frame_comparison's update(i) puts the same three arrays on
    the same artists as the reference's."""
    m1, m2 = movies()
    fig, update = vis.slider_frame_comparison(m1, m2, scale=scale)
    j_fig, j_update = j_vis.slider_frame_comparison(m1, m2, scale=scale)
    for i in (0, 3, 4):
        update(i)
        j_update(i)
        for ax, j_ax in zip(fig.axes[:3], j_fig.axes[:3]):
            np.testing.assert_array_equal(ax.images[0].get_array(),
                                          j_ax.images[0].get_array())
            assert ax.get_title() == j_ax.get_title()
    plt.close('all')


def test_interactive_slider_widget_and_fallback():
    """interactive_slider: the matplotlib Slider in a headless script; the
    ipywidgets explorer swaps frames and rescales the color limits; the
    fallback drives the same update (tests/test_visualization_utils.py's
    checks, on the port)."""
    from matplotlib.widgets import Slider
    movie = np.stack([np.full((4, 4), i, float) for i in range(5)])
    movie[3, 0, 0] = 10.0
    assert isinstance(vis.interactive_slider(movie), Slider)
    plt.close('all')

    import ipywidgets
    widget = vis.interactive_slider(movie, use_widgets=True)
    assert isinstance(widget, ipywidgets.interactive)
    im = plt.gcf().axes[0].images[0]
    widget.children[0].value = 3
    assert float(np.asarray(im.get_array())[0, 0]) == 10.0
    assert im.get_clim() == (3.0, 10.0)
    plt.close('all')

    sl = vis.interactive_slider(movie, use_widgets=False)
    sl.set_val(2)
    assert float(np.asarray(
        sl.ax.figure.axes[0].images[0].get_array()).max()) == 2.0
    plt.close('all')
    with pytest.raises(ValueError):
        vis.interactive_slider(movie[0])


def test_animate_movies_synced_gif(tmp_path):
    """animate_movies_synced writes one GIF frame per movie frame, and its
    update puts the reference's arrays and limits on its artists."""
    m1, m2 = movies()
    kw = dict(vmin=[0, 0], vmax=[1, 1], cmaps=['afmhot', 'RdBu_r'],
              titles=['a', 'b'], fps=5)
    fig, axes = plt.subplots(1, 2)
    anim = vis.animate_movies_synced([m1, m2], axes,
                                     output=str(tmp_path / 'm.gif'), **kw)
    j_fig, j_axes = plt.subplots(1, 2)
    j_anim = j_vis.animate_movies_synced([m1, m2], j_axes, **kw)
    from PIL import Image
    with Image.open(tmp_path / 'm.gif') as gif:
        assert gif.n_frames == m1.shape[0]
    for i in (1, 4):
        for im, j_im in zip(anim._func(i), j_anim._func(i)):
            np.testing.assert_array_equal(im.get_array(), j_im.get_array())
            assert im.get_clim() == j_im.get_clim()
            assert im.get_cmap().name == j_im.get_cmap().name
    assert [a.get_title() for a in axes] == ['a', 'b']
    assert vis.animate_synced is vis.animate_movies_synced
    plt.close('all')


def geodesics_pair(spin=0.5, na=5, nb=4, ngeo=30):
    """The same ray tables as a port Geodesics and a JAX-package one."""
    rng = np.random.default_rng(5)
    shape = (na, nb, ngeo)
    r = np.linspace(40.0, 1.5, ngeo) * (1 + 0.1 * rng.random(shape))
    fields = dict(
        r=r, theta=rng.uniform(0.2, 2.9, shape),
        phi=rng.uniform(-np.pi, np.pi, shape), t=rng.random(shape),
        mino=rng.random(shape), dtau=rng.random(shape),
        pm_r=np.ones(shape), pm_th=np.ones(shape),
        alpha=np.linspace(-10, 10, na)[:, None] * np.ones((na, nb)),
        beta=np.ones((na, nb)), lam=np.ones((na, nb)),
        eta=np.ones((na, nb)), tau_final=np.ones((na, nb)))
    return (Geodesics(**fields, spin=spin, inc=1.0),
            JGeodesics(**fields, spin=spin, inc=1.0))


@pytest.mark.parametrize('ray_indices,max_r',
                         [(None, None), ([0, 7, 19], 20.0)])
def test_plot_geodesic_3D_lines(ray_indices, max_r):
    """plot_geodesic_3D draws the reference's lines (count and 3D data) and
    horizon from the same tables."""
    geos, j_geos = geodesics_pair()
    ax = vis.plot_geodesic_3D(geos, ray_indices, max_r=max_r)
    j_ax = j_vis.plot_geodesic_3D(j_geos, ray_indices, max_r=max_r)
    assert len(ax.lines) == len(j_ax.lines) > 0
    for line, j_line in zip(ax.lines, j_ax.lines):
        for a, b in zip(line.get_data_3d(), j_line.get_data_3d()):
            np.testing.assert_array_equal(a, b)
    assert len(ax.collections) == len(j_ax.collections) == 1
    assert ax.get_xlim() == j_ax.get_xlim()
    plt.close('all')


def chi2_inputs():
    import pandas as pd
    xs = np.array([40.0, 50.0, 60.0, 70.0])
    ys = np.array([3.0, 1.5, 1.0, 2.5])
    return {'series': pd.Series(ys, index=xs), 'pair': (ys, xs),
            'array': ys}


@pytest.mark.parametrize('kind', ['series', 'pair', 'array'])
def test_plot_chi2_data(kind):
    """plot_chi2's curve and truth line from a Series, a (values, index)
    pair and a plain array, as the reference's."""
    chi2 = chi2_inputs()[kind]
    ax = vis.plot_chi2(chi2, true_val=60.0)
    j_ax = j_vis.plot_chi2(chi2, true_val=60.0)
    assert len(ax.lines) == len(j_ax.lines) == 2
    for line, j_line in zip(ax.lines, j_ax.lines):
        for a, b in zip(line.get_data(), j_line.get_data()):
            np.testing.assert_array_equal(np.asarray(a, float),
                                          np.asarray(b, float))
    assert ax.get_xlabel() == j_ax.get_xlabel()
    plt.close('all')


@pytest.mark.parametrize('kind', ['series', 'array'])
def test_animate_chi2_3d_data(kind, tmp_path):
    """animate_chi2_3d: the hypothesis marker, title and clipped image of
    each frame as the reference's, and one GIF frame a hypothesis."""
    chi2 = chi2_inputs()[kind]
    movie = np.random.default_rng(6).random((4, 5, 5)) * 1.5
    anim = vis.animate_chi2_3d(movie, chi2, true_val=60.0,
                               output=str(tmp_path / 'c.gif'))
    j_anim = j_vis.animate_chi2_3d(movie, chi2, true_val=60.0)
    from PIL import Image
    with Image.open(tmp_path / 'c.gif') as gif:
        assert gif.n_frames == 4
    for i in range(4):
        (im, line), (j_im, j_line) = anim._func(i), j_anim._func(i)
        np.testing.assert_array_equal(im.get_array(), j_im.get_array())
        np.testing.assert_array_equal(line.get_xdata(), j_line.get_xdata())
        assert im.axes.figure.axes[0].get_title() == \
            j_im.axes.figure.axes[0].get_title()
    plt.close('all')


def _public_defs(path):
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith('_')]


REFERENCE_MODULES = sorted(
    p.relative_to(REPO).with_suffix('').as_posix().replace('/', '.')
    for p in (REPO / 'bhnerf_tpu').rglob('*.py')
    if p.name != '__init__.py')


@pytest.mark.parametrize('module', REFERENCE_MODULES)
def test_port_has_every_public_name(module):
    """Every public top-level def and class of the JAX package's module
    (read with ast, not imported) is in the port's counterpart module,
    except ROADMAP's "Do not port" names."""
    path = REPO / (module.replace('.', '/') + '.py')
    port = importlib.import_module(
        module.replace('bhnerf_tpu', 'bhnerf_tpu_torch', 1))
    missing = [name for name in _public_defs(path)
               if name not in DO_NOT_PORT and not hasattr(port, name)]
    assert missing == []
