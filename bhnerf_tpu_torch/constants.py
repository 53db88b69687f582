"""Physical constants and Kerr closed forms.

TPU-native rebuild of the reference constants layer
(reference: bhnerf/constants.py:1-18). The reference pulls G, c, M_sun from
astropy; here the CODATA/IAU values are inlined so the framework has no
astropy dependency (astropy is not part of the TPU image).
"""
from __future__ import annotations

import numpy as np

from bhnerf_tpu_torch import units

# --- fundamental constants (SI) ------------------------------------------
G = 6.6743e-11          # m^3 kg^-1 s^-2 (CODATA 2018)
c = 2.99792458e8        # m / s (exact)
M_sun = 1.98892e30      # kg  (IAU nominal solar mass GM/G)
ly = 9.4607304725808e15  # m (exact, julian lightyear)
pc = 3.0856775814913673e16  # m

# --- ISCO radii (closed forms, Bardeen 1972) ------------------------------
# reference: bhnerf/constants.py:7-10
def z1(a):
    return 1 + (1 - a**2) ** (1 / 3) * ((1 + a) ** (1 / 3) + (1 - a) ** (1 / 3))


def z2(a):
    return np.sqrt(3 * a**2 + z1(a) ** 2)


def isco_pro(a):
    """Prograde ISCO radius in M units for dimensionless spin a."""
    return 3 + z2(a) - np.sqrt((3 - z1(a)) * (3 + z1(a) + 2 * z2(a)))


def isco_retro(a):
    """Retrograde ISCO radius in M units for dimensionless spin a."""
    return 3 + z2(a) + np.sqrt((3 - z1(a)) * (3 + z1(a) + 2 * z2(a)))


def r_plus(a):
    """Outer event-horizon radius in M units."""
    return 1.0 + np.sqrt(1.0 - a**2)


# --- black hole unit conversions ------------------------------------------
# reference: bhnerf/constants.py:13-14
def GM_c3(M):
    """Gravitational time M -> seconds. M is a mass Quantity or kg float."""
    M_kg = M.to('kg').value if isinstance(M, units.Quantity) else M
    return units.Quantity(G * M_kg / c**3, 's')


def GM_c2(M):
    """Gravitational length M -> meters. M is a mass Quantity or kg float."""
    M_kg = M.to('kg').value if isinstance(M, units.Quantity) else M
    return units.Quantity(G * M_kg / c**2, 'm')


# --- Sgr A* ---------------------------------------------------------------
# reference: bhnerf/constants.py:17-18
sgra_mass = units.Quantity(4.154e6 * M_sun, 'kg')
sgra_distance = units.Quantity(26673.0, 'lyr')
