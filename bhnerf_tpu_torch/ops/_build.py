"""Build and load the package's CUDA kernels.

Each `csrc/*.cu` source is compiled with `nvcc` for sm_90a into a shared
library with a plain C interface and loaded with ctypes. The build runs
at first use, into `bhnerf_tpu_torch/_build/<hash of the sources>/`, so
a fresh checkout builds everything it needs and an edited source is never
served from a stale library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).parent / 'csrc'
_BUILD_ROOT = Path(__file__).parent.parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for cand in (os.path.join(home, 'bin', 'nvcc'), shutil.which('nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'are built from source at first use')


def build_dir(name):
    """Where `csrc/<name>.cu` is built: keyed by its source and flags."""
    src = _CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_ROOT / digest


@functools.lru_cache(maxsize=None)
def load_library(name):
    """Compile `csrc/<name>.cu` (once per source hash) and return the
    loaded ctypes library; ptxas's report lands beside it."""
    src = _CSRC / f'{name}.cu'
    out_dir = build_dir(name)
    lib_path = out_dir / f'lib{name}.so'
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # build into a temporary name and rename: concurrent processes
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed for {src}:\n{proc.stderr}')
            (out_dir / f'{name}.ptxas.log').write_text(proc.stderr)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib_path))


def check(err, what):
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f'{what} failed with cudaError {err}')
