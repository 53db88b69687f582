"""Plots of fits: the Stokes lightcurve panels and polarization ticks.

PyTorch-package counterpart of `bhnerf_tpu/visualization.py`, of which
`plot_stokes_lc` (:21-53), the lightcurve figure that
`train.logging.SummaryWriter.plot_lc_datafit` logs, and `plot_evpa_ticks`
(:56-67), the EVPA ticks of the Gelles2021 example, are ported so far.
matplotlib is imported by the functions, not with the module.
"""
from __future__ import annotations

import numpy as np


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
