from bhnerf_tpu_torch.geodesics import kerr
from bhnerf_tpu_torch.geodesics.dataset import (Geodesics, image_plane_geos,
                                                subpixel_jittered_axes,
                                                trace_geodesics)
