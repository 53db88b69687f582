"""Port parity of the multi-GPU support on four gloo ranks (mesh (2, 2))
and the two-rank integration of checkpoints, the seed check and SIGTERM
(tests/test_parallel.py:576-670, tests/_two_process_worker.py), on the
CPU. The inputs, the JAX side and the tolerances are those of
test_torch_parallel.py; the ranks are tests/_torch_parallel_worker.py.
"""
import json
import os
import signal
import time

import numpy as np
import pytest

from _torch_cores import cores_per_worker  # noqa: F401 (autouse)
import _torch_parallel_worker as worker
from test_torch_parallel import (Job, TRACE_KW, build_inputs, check_case,
                                 check_census, n_params)
from bhnerf_tpu_torch.geodesics import trace_geodesics


@pytest.fixture(scope='module')
def jobs(tmp_path_factory):
    """One set of inputs; the four-rank compute job (mesh (2, 2), as two
    nodes of two, LOCAL_WORLD_SIZE 2, for create_hybrid_mesh) and the
    two-rank integration job, started together; ranks still running at
    the end of the module are killed."""
    work = tmp_path_factory.mktemp('ranks4')
    prob = build_inputs(work)
    job = Job(work, 4, '2x2', extra_env={'LOCAL_WORLD_SIZE': '2'})
    integration = worker.launch('integration', 2, str(work))
    yield prob, job, integration, work
    for p in job.procs + integration:     # a deselected test's ranks
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope='module')
def four_ranks(jobs):
    return jobs[:2]


@pytest.mark.parametrize('case', ['full', 'tv', 'inject', 'lc'])
def test_sharded_step_matches_jax_2x2(four_ranks, case):
    """Under mesh (2, 2) each rank renders its sample block for its two
    frames of the batch: the images, the global loss and the gradients
    summed over all four ranks match the JAX package's under a (2, 2)
    mesh; tv_scale > 0 counts once; a learned t_injection's gradient
    matches (tests/test_parallel.py:84-146, 368-400)."""
    check_case(four_ranks[1], four_ranks[0], case, (2, 2))


def test_collective_census_2x2(four_ranks):
    """Weak scaling under (2, 2): the image all-reduce over 'ray', one
    gradient all-reduce over every rank, the loss over 'data'."""
    check_census(four_ranks[1], (2, 2), n_params(four_ranks[0]))


def test_lc_census_2x2(four_ranks):
    """The 'lc' loss under (2, 2): a gradient step all-reduces the
    lightcurve of its two frames over 'ray' and no image."""
    check_census(four_ranks[1], (2, 2), n_params(four_ranks[0]), case='lc')


def test_sharded_device_trace_4(four_ranks):
    """The 143 rays padded to 144 over four ranks: every rank holds the
    one-process table within 2e-6."""
    prob, job = four_ranks
    a = prob['arrays']
    ref = trace_geodesics(a['trace_alpha'], a['trace_beta'],
                          backend='device', device='cpu', **TRACE_KW)
    for out in job.outs:
        for f in ('r', 'theta', 'phi', 't', 'tau_final', 'pm_r'):
            np.testing.assert_allclose(out[f'trace/{f}'],
                                       np.asarray(getattr(ref, f)),
                                       rtol=2e-6, atol=2e-6, err_msg=f)


def test_hybrid_mesh_keeps_ray_in_a_node(four_ranks):
    """create_hybrid_mesh((1, 2)) over two nodes of two ranks (a faked
    LOCAL_WORLD_SIZE): shape (2, 2), the node folded into 'data', each
    'ray' row on one node (tests/test_parallel.py:576-622)."""
    outs = four_ranks[1].outs
    rows = {}
    for rank, out in enumerate(outs):
        assert list(out['hybrid_shape']) == [2, 2]
        data, ray = (int(c) for c in out['hybrid_coords'])
        assert rank == 2 * data + ray
        rows.setdefault(data, set()).add(rank // 2)
    assert all(len(nodes) == 1 for nodes in rows.values())
    assert {min(n) for n in rows.values()} == {0, 1}


@pytest.fixture(scope='module')
def integration(jobs):
    """The integration job's results; the test sends SIGTERM to both
    ranks once both wait at step 8 of the preempted run."""
    procs, work = jobs[2:]
    ready = [work / f'ready_{r}' for r in range(2)]
    deadline = time.time() + 240
    while not all(p.exists() for p in ready):
        if time.time() > deadline or any(p.poll() is not None
                                         for p in procs):
            break
        time.sleep(0.05)
    if all(p.exists() for p in ready):
        for p in procs:
            os.kill(p.pid, signal.SIGTERM)
        (work / 'go').touch()
    worker.finish(procs)
    return [json.loads((work / f'integration_{r}.json').read_text())
            for r in range(2)]


def test_two_rank_checkpoints(integration):
    """Rank 0 alone writes and prunes (keep 1: checkpoint_10 remains);
    both ranks restore the same step with the same parameters; rank-local
    directories that disagree raise RuntimeError on both ranks
    (tests/test_parallel.py:630-670, state.py:149, 160-179)."""
    r0, r1 = integration
    assert r0['writes'] == [5, 10] and r1['writes'] == []
    for r in integration:
        assert r['listing'] == ['NeRF_Predictor_params.yml', 'checkpoint_10']
        assert r['restored_step'] == 10 and r['restored_equal']
        assert 'disagrees across' in r['disagree_error']
        assert 'checkpoint_dir' in r['disagree_error']
    assert r0['trained'] == r1['trained']


def test_two_rank_seed_check(integration):
    """Ranks given different seeds would draw different batches: run
    raises RuntimeError on both before training."""
    for r in integration:
        assert 'different seeds' in r['seed_error']


def test_two_rank_sigterm_resume(integration):
    """A SIGTERM to both ranks during step 8: both stop at step 8, rank 0
    checkpoints it, and a new run resumes from it on both ranks with the
    same global losses."""
    r0, r1 = integration
    for r in integration:
        assert r['stopped_at'] == 8
        assert r['preempt_listing'] == ['NeRF_Predictor_params.yml',
                                        'checkpoint_8']
        assert r['resumed_from'] == 8
        assert [s for s, _ in r['resumed_losses']] == [9, 10, 11, 12]
        assert all(np.isfinite(v) for _, v in r['resumed_losses'])
    assert r0['resumed_losses'] == r1['resumed_losses']
