"""Plots of fits and renders of recovered volumes.

PyTorch-package counterpart of `bhnerf_tpu/visualization.py`: the Stokes
lightcurve panels (:21-53) and polarization ticks (:56-67), the movie
comparisons and animations (:70-208), the 3D ray viewer (:211-238), the
flat-space volume renderers `VolumeVisualizer` (:244-362) and
`ipyvolume_3d` (:365-471), and the chi^2 scan plots (:474-545).

The two volume compositors, `_vv_composite` and `_transfer_composite`,
are torch functions on the device of their inputs (the card unless the
caller asks for the CPU); the camera, the colormap, the overlays and the
figures stay host numpy and matplotlib, as in the reference. matplotlib
is imported by the functions that draw, not with the module, so the
compositors run where matplotlib is not installed.
"""
from __future__ import annotations

import numpy as np
import torch

from bhnerf_tpu_torch.emission import map_coordinates_linear


# ---------------------------------------------------------------------------
# lightcurve / polarization plots
# ---------------------------------------------------------------------------
def plot_stokes_lc(lightcurves, stokes=('I', 'Q', 'U'), t_frames=None,
                   axes=None, plot_qu_loop=True, add_mean=False, fmt='.',
                   color=None, label=None, fontsize=12):
    """One panel per Stokes lightcurve of `lightcurves` (nt, len(stokes)),
    plus the Q-U loop when Q and U are both given (reference
    visualization.py:21-53). Returns the axes."""
    import matplotlib.pyplot as plt
    lightcurves = np.asarray(lightcurves)
    stokes = list(np.atleast_1d(stokes))
    qu_loop = plot_qu_loop and {'Q', 'U'} <= set(stokes)
    n_panels = len(stokes) + (1 if qu_loop else 0)
    if axes is None:
        _, axes = plt.subplots(1, n_panels, figsize=(3.2 * n_panels, 3))
    axes = np.atleast_1d(axes)
    t = np.arange(lightcurves.shape[0]) if t_frames is None else \
        np.asarray(t_frames)
    for i, s in enumerate(stokes):
        axes[i].plot(t, lightcurves[:, i], fmt, color=color, label=label)
        axes[i].set_title(s, fontsize=fontsize)
        axes[i].set_xlabel('t')
    if qu_loop:
        qi, ui = stokes.index('Q'), stokes.index('U')
        ax = axes[-1]
        ax.plot(lightcurves[:, qi], lightcurves[:, ui], fmt, color=color,
                label=label)
        if add_mean:
            ax.scatter(lightcurves[:, qi].mean(), lightcurves[:, ui].mean(),
                       marker='+', color=color)
        ax.set_title('Q-U loop', fontsize=fontsize)
        ax.set_xlabel('Q')
        ax.set_ylabel('U')
        ax.set_aspect('equal')
    plt.tight_layout()
    return axes


def plot_evpa_ticks(Q, U, alpha, beta, ax=None, color='white', scale=25,
                    width=0.004, headwidth=0):
    """Polarization ticks at screen points (alpha, beta): headless quivers
    of length sqrt(Q^2 + U^2) along the EVPA, measured East of North
    (reference visualization.py:56-67). Returns the axes."""
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    evpa = 0.5 * np.arctan2(np.asarray(U), np.asarray(Q))
    p = np.sqrt(np.asarray(Q) ** 2 + np.asarray(U) ** 2)
    ax.quiver(alpha, beta, -p * np.sin(evpa), p * np.cos(evpa),
              color=color, scale=scale, width=width, headwidth=headwidth,
              headlength=0, headaxislength=0, pivot='mid')
    return ax


# ---------------------------------------------------------------------------
# movie comparisons and animations
# ---------------------------------------------------------------------------
def slider_frame_comparison(movie1, movie2, scale='amp', title1='true',
                            title2='estimate'):
    """Frame-by-frame comparison of two (nt, ny, nx) movies and their
    difference under a matplotlib Slider (reference visualization.py:
    70-106; scale='log' shows log10 of the magnitudes). Returns (fig,
    update); headless, update(i) shows frame i."""
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider
    movie1, movie2 = np.asarray(movie1), np.asarray(movie2)
    if scale == 'log':
        movie1, movie2 = np.log10(np.abs(movie1) + 1e-12), \
            np.log10(np.abs(movie2) + 1e-12)
    fig, axes = plt.subplots(1, 3, figsize=(10, 3.5),
                             gridspec_kw={'width_ratios': [1, 1, 1]})
    ims = [axes[0].imshow(movie1[0]), axes[1].imshow(movie2[0]),
           axes[2].imshow(movie1[0] - movie2[0], cmap='RdBu_r')]
    for ax, ti in zip(axes, (title1, title2, 'difference')):
        ax.set_title(ti)
        ax.set_xticks([])
        ax.set_yticks([])
    plt.subplots_adjust(bottom=0.2)
    s_ax = fig.add_axes([0.25, 0.05, 0.5, 0.04])
    slider = Slider(s_ax, 'frame', 0, movie1.shape[0] - 1, valinit=0,
                    valstep=1)

    def update(i):
        i = int(i)
        ims[0].set_array(movie1[i])
        ims[1].set_array(movie2[i])
        ims[2].set_array(movie1[i] - movie2[i])
        fig.canvas.draw_idle()

    slider.on_changed(update)
    fig._slider = slider  # keep a reference alive
    return fig, update


def interactive_slider(movie, ax=None, cmap=None, extent=None,
                       use_widgets=None):
    """Frame explorer of a (nt, ny, nx) movie with per-frame color limits
    (reference visualization.py:109-171): an ipywidgets slider where
    ipywidgets and a live IPython display are there (use_widgets=None
    decides so), else a matplotlib Slider. Returns the ipywidgets widget
    (drive it with ``widget.children[0].value = i``) or the Slider."""
    import matplotlib.pyplot as plt
    movie = np.asarray(movie).squeeze()
    if movie.ndim != 3:
        raise ValueError(f'movie must be 3D (t, ny, nx); got shape '
                         f'{movie.shape}')
    if use_widgets is None:
        # an undisplayed widget renders nothing: a plain script takes the
        # matplotlib Slider
        try:
            import ipywidgets  # noqa: F401
            import IPython
            use_widgets = IPython.get_ipython() is not None
        except ImportError:
            use_widgets = False

    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    im = ax.imshow(movie[0], origin='lower', cmap=cmap, extent=extent)
    fig.colorbar(im, ax=ax)

    def show_frame(frame=0):
        img = movie[int(frame)]
        im.set_array(img)
        im.set_clim(float(img.min()), float(img.max()))
        fig.canvas.draw_idle()

    if use_widgets:
        from ipywidgets import interactive
        widget = interactive(show_frame, frame=(0, movie.shape[0] - 1))
        try:
            import IPython
            if IPython.get_ipython() is not None:
                from IPython.display import display
                display(widget)
        except ImportError:
            pass
        return widget

    from matplotlib.widgets import Slider
    fig.subplots_adjust(bottom=0.2)
    s_ax = fig.add_axes([0.25, 0.05, 0.5, 0.04])
    slider = Slider(s_ax, 'frame', 0, movie.shape[0] - 1, valinit=0,
                    valstep=1)
    slider.on_changed(show_frame)
    fig._slider = slider
    return slider


def animate_movies_synced(movies, axes, t_frames=None, vmin=None, vmax=None,
                          cmaps='afmhot', titles=None, fps=10,
                          output=None):
    """Side-by-side animation of movies of one frame count on `axes`,
    each with its own colormap and limits (reference visualization.py:
    174-205); saved as a GIF when `output` is given. Returns the
    FuncAnimation."""
    from matplotlib import animation
    del t_frames  # accepted for the reference's signature
    movies = [np.asarray(m) for m in movies]
    axes = np.atleast_1d(axes)
    nt = movies[0].shape[0]
    if isinstance(cmaps, str):
        cmaps = [cmaps] * len(movies)
    vmin = [m.min() for m in movies] if vmin is None else np.atleast_1d(vmin)
    vmax = [m.max() for m in movies] if vmax is None else np.atleast_1d(vmax)
    images = []
    for ax, movie, cm, lo, hi in zip(axes, movies, cmaps, vmin, vmax):
        images.append(ax.imshow(movie[0], cmap=cm, vmin=lo, vmax=hi))
        ax.set_xticks([])
        ax.set_yticks([])
    if titles is not None:
        for ax, ti in zip(axes, titles):
            ax.set_title(ti)

    def update(i):
        for im, movie in zip(images, movies):
            im.set_array(movie[i])
        return images

    anim = animation.FuncAnimation(axes[0].get_figure(), update, frames=nt,
                                   interval=1000 / fps, blit=True)
    if output is not None:
        anim.save(output, writer='pillow', fps=fps)
    return anim


animate_synced = animate_movies_synced


def plot_geodesic_3D(geos, ray_indices=None, ax=None, max_r=None):
    """3D lines of the rays numbered `ray_indices` (32 spread over the
    screen by default) within max_r of the origin, with the event-horizon
    sphere (reference visualization.py:211-238). geos: a Geodesics.
    Returns the 3D axes."""
    import matplotlib.pyplot as plt
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection='3d')
    npix = geos.npix
    xf, yf, zf = (np.asarray(a).reshape(npix, -1)
                  for a in (geos.x, geos.y, geos.z))
    if ray_indices is None:
        ray_indices = np.linspace(0, npix - 1, 32).astype(int)
    max_r = max_r or 1.5 * np.abs(geos.alpha).max()
    for i in ray_indices:
        r = np.sqrt(xf[i] ** 2 + yf[i] ** 2 + zf[i] ** 2)
        m = r < max_r
        ax.plot(xf[i][m], yf[i][m], zf[i][m], lw=0.5)
    rh = 1 + np.sqrt(1 - geos.spin ** 2)
    u_s, v_s = np.mgrid[0:2 * np.pi:20j, 0:np.pi:10j]
    ax.plot_surface(rh * np.cos(u_s) * np.sin(v_s),
                    rh * np.sin(u_s) * np.sin(v_s), rh * np.cos(v_s),
                    color='black')
    ax.set_xlim(-max_r, max_r)
    ax.set_ylim(-max_r, max_r)
    ax.set_zlim(-max_r, max_r)
    return ax


# ---------------------------------------------------------------------------
# flat-space volume renderers
# ---------------------------------------------------------------------------
def _sample_volume(volume, cam, dirs, ts, extent):
    """The sample points cam + dirs * ts (h, w, s, 3) and the volume's
    trilinear value at each (map_coordinates order 1, cval 0), for a
    volume that spans [-extent, extent] on each axis."""
    pts = cam[None, None, None] + dirs[:, :, None] * ts[None, None, :, None]
    npix_grid = torch.tensor(volume.shape, dtype=pts.dtype,
                             device=pts.device)
    idx = (pts + extent) / (2 * extent) * (npix_grid - 1)
    return pts, map_coordinates_linear(volume, idx)


def _composite_weights(alpha):
    """Each sample's share of its ray, alpha times the transmittance of
    the samples before it (exclusive cumprod)."""
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    return alpha * trans


def _vv_composite(volume, cam, dirs, ts, dt, extent, sigma_scale,
                  bh_radius, w_edge, cube_alpha, draw_cube, has_bh):
    """Alpha-composite `volume` along the rays cam + dirs * ts with the
    optional black-hole sphere and cube-wireframe overlays (reference
    visualization.py:244-289). volume (nx, ny, nz), cam (3,), dirs
    (h, w, 3) and ts (s,) are float32 tensors on one device; the scalars
    are Python numbers; draw_cube and has_bh are Python flags. Returns the
    four (h, w) layers (emission, BH shadow, wireframe, BH shade) on that
    device."""
    pts, em = _sample_volume(volume, cam, dirs, ts, extent)
    if has_bh:
        r = torch.sqrt(torch.sum(pts ** 2, dim=-1))
        opaque = r < bh_radius
        # Lambert term of the first sphere hit (limb darkening)
        cosv = torch.clamp(-torch.sum(pts * dirs[:, :, None], dim=-1)
                           / torch.clamp(r, min=1e-9), 0.0, 1.0)
    else:
        opaque = torch.zeros_like(em, dtype=torch.bool)
        cosv = torch.zeros_like(em)
    alpha = 1.0 - torch.exp(-sigma_scale * em * dt)
    alpha = torch.where(opaque, torch.ones_like(alpha), alpha)
    if draw_cube:
        # a point lies on a wireframe edge when >= 2 coordinates are
        # within w_edge of a cube face (and inside the cube)
        ax3 = torch.abs(pts)
        inside = torch.all(ax3 <= extent + w_edge, dim=-1)
        n_face = torch.sum(ax3 >= extent - w_edge, dim=-1)
        edge = inside & (n_face >= 2)
        alpha = 1.0 - (1.0 - alpha) * (1.0 - torch.where(
            edge, cube_alpha, 0.0))
    else:
        edge = torch.zeros_like(em, dtype=torch.bool)
    weights = _composite_weights(alpha)
    return (torch.sum(weights * em, dim=-1),
            torch.sum(weights * opaque, dim=-1),
            torch.sum(weights * edge, dim=-1),
            torch.sum(weights * opaque * cosv, dim=-1))


def _float32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class VolumeVisualizer:
    """Pinhole-camera renderer of recovered 3D emission volumes
    (reference visualization.py:292-362): camera rays on the host,
    trilinear sampling and alpha compositing on `device`."""

    def __init__(self, resolution=(256, 256), fov=30.0, samples=128,
                 device='cuda'):
        self.resolution = tuple(resolution)
        self.fov_deg = fov
        self.samples = samples
        self.device = device

    def _rays(self, azimuth, zenith, distance):
        """The camera at `distance` on the sphere (azimuth, zenith),
        looking at the origin, and its (h, w, 3) unit ray directions:
        built in float64 on the host and cast to float32 tensors on the
        device."""
        h, w = self.resolution
        fov_r = np.deg2rad(self.fov_deg)
        cam = distance * np.array([
            np.sin(zenith) * np.cos(azimuth),
            np.sin(zenith) * np.sin(azimuth),
            np.cos(zenith)])
        forward = -cam / np.linalg.norm(cam)
        up0 = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up0)
        if np.linalg.norm(right) < 1e-8:
            right = np.array([1.0, 0.0, 0.0])
        right = right / np.linalg.norm(right)
        up = np.cross(right, forward)
        ii, jj = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
        half = np.tan(fov_r / 2)
        dirs = (forward[None, None] + half * (ii[..., None] * right
                + jj[..., None] * up))
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        return _float32(cam, self.device), _float32(dirs, self.device)

    def composite(self, volume, extent, azimuth=0.3, zenith=np.pi / 3,
                  distance=None, sigma_scale=10.0, bh_radius=None,
                  draw_cube=False, cube_width=0.012, cube_alpha=0.85):
        """The four (h, w) layers of a view as numpy arrays: emission, BH
        shadow, wireframe and BH shade (the arguments of `render`)."""
        distance = distance or 3.0 * extent
        cam, dirs = self._rays(azimuth, zenith, distance)
        t_near = distance - 1.8 * extent
        t_far = distance + 1.8 * extent
        ts = _float32(np.linspace(t_near, t_far, self.samples), self.device)
        layers = _vv_composite(
            _float32(volume, self.device), cam, dirs, ts,
            (t_far - t_near) / self.samples, extent, sigma_scale,
            0.0 if bh_radius is None else bh_radius, cube_width * extent,
            cube_alpha, draw_cube=bool(draw_cube),
            has_bh=bh_radius is not None)
        return tuple(layer.cpu().numpy() for layer in layers)

    def render(self, volume, extent, azimuth=0.3, zenith=np.pi / 3,
               distance=None, sigma_scale=10.0, bh_radius=None,
               cmap='hot', draw_cube=False, cube_width=0.012,
               cube_alpha=0.85, bh_shade=0.25):
        """(h, w, 3) RGB of the volume with optional overlays.

        volume: (nx, ny, nz) emission; extent: half-width of the cube [M].
        draw_cube=True composites the bounding-cube wireframe (edge
        proximity of the sample points, so emission in front occludes it);
        bh_radius draws the black-hole sphere with a Lambert-shaded limb.
        """
        layers = self.composite(volume, extent, azimuth, zenith, distance,
                                sigma_scale, bh_radius, draw_cube,
                                cube_width, cube_alpha)
        return layers_to_rgb(*layers, cmap=cmap, bh_shade=bh_shade)


def layers_to_rgb(img, shadow, wire, shade, cmap='hot', bh_shade=0.25):
    """RGB of VolumeVisualizer's layers (reference visualization.py:
    352-362): the colormapped emission, darkened by the BH silhouette with
    a faintly shaded limb, under the wireframe's white overlay."""
    import matplotlib.pyplot as plt
    cm = plt.get_cmap(cmap)
    rgb = cm(img / max(img.max(), 1e-12))[..., :3]
    rgb = rgb * (1.0 - shadow[..., None]) + bh_shade * shade[..., None]
    wire = np.clip(wire, 0.0, 1.0)[..., None]
    rgb = rgb * (1.0 - wire) + wire
    return np.clip(rgb, 0.0, 1.0)


def interp(x, xp, fp):
    """jnp.interp(x, xp, fp) in torch: piecewise-linear through the nodes
    (xp increasing), fp[0] below xp[0] and fp[-1] above xp[-1]."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # jnp.interp's guard against a zero-width segment
    eps = np.spacing(np.finfo(np.float32).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _transfer_composite(volume, vmax, cam, dirs, ts, dt, extent, levels,
                        opacities):
    """Alpha-composite a volume with an ipyvolume-style piecewise-linear
    transfer function (reference visualization.py:365-391): each sample's
    opacity is interp(em / vmax, levels, opacities), scaled to the step
    length against 128 samples across the box. vmax comes from the
    caller, so the frames of a movie share one normalisation. Tensors on
    one device as in _vv_composite; returns (intensity, alpha), each
    (h, w)."""
    ref_step = 2 * extent / 128.0
    _, em = _sample_volume(volume, cam, dirs, ts, extent)
    em_n = em / max(vmax, 1e-12)
    alpha = torch.clamp(interp(em_n, levels, opacities), 0.0, 1.0)
    alpha = 1.0 - (1.0 - alpha) ** (dt / ref_step)
    weights = _composite_weights(alpha)
    return torch.sum(weights * em_n, dim=-1), torch.sum(weights, dim=-1)


def ipyvolume_3d(volume, fov, azimuth=0, elevation=-60, distance=2.5,
                 level=(0.0, 0.2, 0.7), opacity=(0.0, 0.2, 0.3),
                 controls=False, resolution=(256, 256), samples=128,
                 cmap='magma', fps=10, output=None, device='cuda'):
    """Volume rendering with an ipyvolume-style transfer function
    (reference visualization.py:394-466), composited on `device`.

    `level`/`opacity` are the piecewise-linear transfer-function nodes of
    ipv.volshow (normalized emission -> opacity); azimuth/elevation are in
    degrees and distance in bounding-box units, as in ipv.view. A 3D
    volume returns (fig, rgb image); a 4D one a FuncAnimation over its
    leading time axis, every frame normalised by the one maximum of the
    whole input (saved as a GIF when `output` is given).
    """
    import matplotlib.pyplot as plt
    del controls  # interactivity is the matplotlib backend's
    volume = np.asarray(volume)
    if volume.ndim not in (3, 4):
        raise AttributeError(
            f'volume.ndim = {volume.ndim} not supported')

    extent = fov / 2.0
    vv = VolumeVisualizer(resolution=resolution, fov=45.0, samples=samples,
                          device=device)
    dist = max(float(distance), 1.2) * fov
    cam, dirs = vv._rays(np.deg2rad(azimuth), np.deg2rad(90.0 - elevation),
                         dist)
    t_near, t_far = dist - 1.8 * extent, dist + 1.8 * extent
    ts = _float32(np.linspace(t_near, t_far, samples), device)
    dt = (t_far - t_near) / samples
    levels, opacities = _float32(level, device), _float32(opacity, device)
    cm = plt.get_cmap(cmap)
    # one global maximum for the whole input (movie frames must share a
    # normalization or a decaying hotspot renders as constant brightness)
    vmax = float(volume.max())

    def composite_frame(vol):
        img, a = _transfer_composite(_float32(vol, device), vmax, cam, dirs,
                                     ts, dt, extent, levels, opacities)
        return img.cpu().numpy(), np.clip(a.cpu().numpy(), 0.0, 1.0)

    def to_rgb(img, a, img_max):
        rgb = cm(img / max(img_max, 1e-12))[..., :3]
        return rgb * a[..., None]  # fade to black background

    if volume.ndim == 3:
        fig, ax = plt.subplots()
        img, a = composite_frame(volume)
        rgb = to_rgb(img, a, img.max())
        ax.imshow(rgb, origin='lower')
        ax.set_axis_off()
        return fig, rgb

    from matplotlib import animation
    composited = [composite_frame(v) for v in volume]
    img_max = max(img.max() for img, _ in composited)
    frames = [to_rgb(img, a, img_max) for img, a in composited]
    fig, ax = plt.subplots()
    im = ax.imshow(frames[0], origin='lower')
    ax.set_axis_off()

    def update(i):
        im.set_array(frames[i])
        return [im]

    anim = animation.FuncAnimation(fig, update, frames=len(frames),
                                   interval=1000 / fps, blit=True)
    if output is not None:
        anim.save(output, writer='pillow', fps=fps)
    return anim


# ---------------------------------------------------------------------------
# chi^2 hypothesis-scan plots
# ---------------------------------------------------------------------------
def plot_chi2(chi2, true_val=None, ax=None, xlabel=r'$\theta_o$ [deg]',
              color='tab:red', label=r'$\chi^2$'):
    """chi^2 against the hypothesis parameter, with the truth marked
    (reference visualization.py:474-497). chi2: a pandas Series indexed
    by the hypothesis values (e.g. alma.chi2_df averaged over seeds), a
    (values, index) pair of arrays, or a plain array (against its
    positions). Returns the axes."""
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    if isinstance(chi2, (tuple, list)):
        ys, xs = np.asarray(chi2[0], float), np.asarray(chi2[1], float)
    elif hasattr(chi2, 'index') and not callable(chi2.index):
        xs, ys = np.asarray(chi2.index, float), np.asarray(chi2.values)
    else:
        ys = np.asarray(chi2, float)
        xs = np.arange(ys.shape[0], dtype=float)
    ax.plot(xs, ys, '.-', color=color, label=label)
    if true_val is not None:
        ax.axvline(true_val, color='black', linestyle=':', label='true')
    ax.set_xlabel(xlabel)
    ax.set_ylabel(r'$\chi^2$')
    return ax


def animate_chi2_3d(movie, chi2, true_val=None, figsize=(9, 4),
                    legend_loc='lower right', cmap='afmhot', fps=10,
                    output=None, writer='pillow',
                    xlabel=r'$\theta_o$ [deg]'):
    """Animate a hypothesis scan: the chi^2 curve with a moving hypothesis
    marker beside that hypothesis' emission estimate (reference
    visualization.py:500-545). movie: (n_hyp, h, w) renders, one a
    hypothesis; chi2: a pandas Series indexed by the hypothesis values,
    or an array (against its positions). Returns the FuncAnimation."""
    import matplotlib.pyplot as plt
    from matplotlib import animation
    movie = np.asarray(movie)
    if hasattr(chi2, 'index') and not callable(chi2.index):
        xs = np.asarray(chi2.index, float)
    else:
        xs = np.arange(movie.shape[0], dtype=float)
        chi2 = (np.asarray(chi2, float), xs)

    fig, axes = plt.subplots(1, 2, figsize=figsize)
    plot_chi2(chi2, true_val, ax=axes[0], xlabel=xlabel)
    line = axes[0].axvline(xs[0], color='blue', linestyle='--',
                           label='hypothesis')
    axes[0].legend(loc=legend_loc)
    axes[0].set_xlim(xs[0], xs[-1])
    axes[1].set_title('Emission estimate')
    axes[1].set_axis_off()
    im = axes[1].imshow(movie[0].clip(max=1), cmap=cmap,
                        vmin=0.0, vmax=1.0)
    plt.tight_layout()

    def update(i):
        axes[0].set_title(
            rf'Emission estimate: $\theta_o={xs[i]:1.1f}$')
        im.set_array(movie[i].clip(max=1))
        line.set_xdata([xs[i]])
        return im, line

    anim = animation.FuncAnimation(fig, update, frames=movie.shape[0],
                                   interval=1e3 / fps)
    if output is not None:
        anim.save(output, writer=writer, fps=fps)
    return anim
