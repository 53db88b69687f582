"""Reference-API facade for the GR geometry layer.

PyTorch counterpart of `bhnerf_tpu/kgeo.py`: the reference exposes
geodesics and tensor algebra under `bhnerf.kgeo`; here they live in
`bhnerf_tpu_torch.geodesics` (ray tracing) and `bhnerf_tpu_torch.ops.gr`
(tensor algebra), re-exported under the reference names so code written
against the reference ports by changing the import root.
"""
import numpy as np

from bhnerf_tpu_torch.geodesics.dataset import (Geodesics, image_plane_geos,
                                                trace_geodesics)
from bhnerf_tpu_torch.ops.gr import (azimuthal_velocity_vector,
                                     doppler_factor, fluid_frame_tetrad,
                                     inv_metric_components,
                                     magnetic_field_fluid_frame,
                                     metric_components, parallel_transport,
                                     parallel_transport_zamo,
                                     radiative_trasfer, radiative_transfer,
                                     raise_or_lower_indices,
                                     transform_coordinates, wave_vector,
                                     zamo_frame_tetrad, zamo_frame_velocity)
from bhnerf_tpu_torch.geodesics import equatorial as equatorial_lensing


def spacetime_metric(geos):
    """The Kerr metric along a Geodesics bundle (reference kgeo.py:118-143
    signature)."""
    return metric_components(geos.r, geos.theta, geos.spin, geos.M)


def spacetime_inv_metric(geos):
    """The inverse Kerr metric along a Geodesics bundle (reference
    kgeo.py:145-171 signature)."""
    return inv_metric_components(geos.r, geos.theta, geos.spin, geos.M)


def magnetic_field_spherical(geos, b_r, b_th, b_ph):
    """Constant or spatially varying spherical B components stacked on a
    trailing mu axis (reference kgeo.py:250-272)."""
    shape = geos.r.shape
    comps = [np.broadcast_to(np.asarray(c, dtype=float), shape)
             for c in (b_r, b_th, b_ph)]
    return np.stack(comps, axis=-1)
