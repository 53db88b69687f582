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
