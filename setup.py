"""Package setup (reference setup.py parity)."""
from setuptools import find_packages, setup

setup(
    name='bhnerf_tpu',
    version='1.0.0',
    description=('TPU-native neural 3D tomography of black-hole emission '
                 'with general-relativistic ray tracing'),
    packages=find_packages(include=['bhnerf_tpu', 'bhnerf_tpu.*',
                                    'bhnerf_tpu_torch', 'bhnerf_tpu_torch.*']),
    # the PyTorch port builds its CUDA kernels from these sources at first use
    package_data={'bhnerf_tpu_torch.ops': ['csrc/*.cu'],
                  'bhnerf_tpu_torch.scripts': ['*.yaml']},
    python_requires='>=3.10',
    install_requires=['jax', 'numpy', 'optax', 'pyyaml'],
    extras_require={
        'full': ['orbax-checkpoint', 'tensorboardX', 'matplotlib',
                 'pandas', 'tqdm'],
        # bhnerf_tpu_torch, the PyTorch + CUDA port
        'torch': ['torch'],
    },
)
