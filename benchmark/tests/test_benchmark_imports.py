"""Nothing the harness or the reference loads is JAX or the JAX package;
the comparison is by whole top-level name, since the port's name begins
with the JAX package's."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


def loaded(modules):
    code = ('import sys, json; sys.path.insert(0, %r)\n' % str(ROOT)
            + ''.join(f'import {m}\n' for m in modules)
            + 'print(json.dumps(sorted({m.split(".")[0] '
              'for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize('modules', [
    ['benchmark.run', 'benchmark.check', 'benchmark.trace',
     'benchmark.kinds.nerf_fit', 'benchmark.calibrate', 'benchmark.faults',
     'bhnerf_tpu_torch.train', 'bhnerf_tpu_torch.alma'],
    ['benchmark.reference.nerf', 'benchmark.reference.tables',
     'benchmark.inputs'],
])
def test_no_jax_loaded(modules):
    top = loaded(modules)
    assert not top & {'jax', 'jaxlib', 'flax', 'bhnerf_tpu'}, top


def test_reference_loads_nothing_of_the_program():
    top = loaded(['benchmark.reference.nerf', 'benchmark.reference.tables',
                  'benchmark.reference.geodesics',
                  'benchmark.reference.physics'])
    assert 'bhnerf_tpu_torch' not in top and 'bhnerf_tpu' not in top


def test_forbidden_modules_compare_whole_names():
    from benchmark import run
    assert run.forbidden_modules(['bhnerf_tpu_torch', 'bhnerf_tpu_torch.ops',
                                  'jaxtyping', 'numpy']) == []
    assert run.forbidden_modules(['bhnerf_tpu.train', 'jax.numpy',
                                  'flax']) == ['bhnerf_tpu', 'flax', 'jax']
