from bhnerf_tpu_torch.geodesics import kerr
from bhnerf_tpu_torch.geodesics.dataset import (Geodesics, image_plane_geos,
                                                trace_geodesics)
