"""bhnerf_tpu_torch: the PyTorch + CUDA port of bhnerf_tpu.

Black-hole emission tomography (a NeRF emission field fitted through
general-relativistic ray tracing) on PyTorch, with the fused render hot
path as hand-written CUDA kernels for Hopper (sm_90a). Module paths mirror
the JAX package: `bhnerf_tpu/X.py` has its counterpart at
`bhnerf_tpu_torch/X.py`. This package imports torch and numpy, never jax;
CUDA kernels are built at first use on a machine with nvcc.
"""
from bhnerf_tpu_torch import constants, units, utils
from bhnerf_tpu_torch import geodesics
from bhnerf_tpu_torch import ops
from bhnerf_tpu_torch import emission
from bhnerf_tpu_torch import models
from bhnerf_tpu_torch import train
from bhnerf_tpu_torch import alma
from bhnerf_tpu_torch import observation
from bhnerf_tpu_torch import config
from bhnerf_tpu_torch import visualization
# reference-API facades (bhnerf.kgeo / bhnerf.network / bhnerf.optimization)
from bhnerf_tpu_torch import kgeo
from bhnerf_tpu_torch import network
from bhnerf_tpu_torch import optimization
from bhnerf_tpu_torch.models.fields import (GRID_Predictor, GridPredictor,
                                            NeRF_Predictor, NeRFPredictor,
                                            apply_mlp, init_mlp_params,
                                            posenc, sample_3d_grid)
