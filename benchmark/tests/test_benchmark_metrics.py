"""The yardstick's arithmetic and the metric readers on fixed inputs."""
from __future__ import annotations

import types

import pytest

from benchmark import run, trace
from benchmark.metrics import _work


def test_mlp_flops_per_sample_by_hand():
    # 4x128, posenc 3: 21 features; layers 21->128, 128->128, 128->128,
    # then the skip concatenates the 21 features: 149->128, head 128->1
    hand = 2 * (21 * 128 + 128 * 128 + 128 * 128 + 149 * 128 + 128 * 1)
    assert hand == 109_312
    assert _work.mlp_flops_per_sample(21, 4, 128) == hand
    assert _work.mlp_params(21, 4, 128) == 55_169


def test_roofline_of_the_t3_forward():
    w = {'n_eff': 68_352, 'batch': 6, 'mlp': (21, 4, 128)}
    flops, nbytes = _work.forward_work(w)
    assert flops == 109_312 * 68_352 * 6
    # compute-bound: 4.48e10 FLOP at 495 TFLOP/s is 90.6 us, the bytes
    # (3.2 MB at 3.35 TB/s) about 1 us
    assert nbytes / _work.HBM_BYTES_PER_S < flops / 495e12
    share = _work.roofline_percent(flops, nbytes, 1.08e-3, 'float32')
    assert share == pytest.approx(8.3857, rel=1e-4)
    bflops, _ = _work.backward_work(w)
    assert bflops == 2 * flops
    assert _work.roofline_percent(bflops, 0, 5.77e-3, 'float32') == \
        pytest.approx(3.1392, rel=1e-4)
    # a bf16 cell is held to the bf16 peak
    assert _work.roofline_percent(flops, nbytes, 1.08e-3, 'bfloat16') == \
        pytest.approx(share * 495 / 989, rel=1e-6)


def test_memory_bound_side_of_the_roofline():
    assert _work.roofline_percent(1.0, 3.35e9, 2e-3, 'float32') == \
        pytest.approx(50.0)


def _fake_trace(events):
    return trace.Trace(events)


def test_trace_busy_union_and_gaps():
    ev = [
        {'ph': 'X', 'cat': 'kernel', 'name': 'void fused_render_fwd_kernel',
         'ts': 0.0, 'dur': 100.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'void fused_render_bwd_kernel',
         'ts': 50.0, 'dur': 100.0},       # overlaps: busy 0-150
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD',
         'ts': 400.0, 'dur': 100.0},      # gap 150-400
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::copy_', 'ts': 140.0,
         'dur': 400.0},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaMemcpyAsync',
         'ts': 200.0, 'dur': 150.0},      # innermost at t = 275
    ]
    t = _fake_trace(ev)
    assert t.busy_s == pytest.approx(250e-6)
    assert t.seconds(_work.is_forward) == pytest.approx(100e-6)
    assert t.seconds(_work.is_backward) == pytest.approx(100e-6)
    assert t.idle_gaps == [['cudaMemcpyAsync', pytest.approx(250e-6)]]
    assert t.device_ops[0][1] == pytest.approx(100e-6)


def _run(loop, trace_obj=None, steps=100, elapsed=1.0, times=None):
    window = types.SimpleNamespace(steps=steps, elapsed=elapsed,
                                   step_seconds=times or [])
    profiled = types.SimpleNamespace(steps=10, elapsed=0.2)
    return types.SimpleNamespace(
        loop=loop, window=window, profiled=profiled, trace=trace_obj,
        setup_s=12.5, phases={'precompute.a': 1.0, 'precompute.b': 2.0,
                              'warm_up': 3.0},
        work={'n_eff': 1000, 'batch': 6, 'mlp': (21, 4, 128),
              'compute_dtype': 'float32'})


def test_end_to_end_readers():
    assert run.reader('train_steps_per_s')(_run('chunked')) == 100.0
    assert run.reader('train_steps_per_s')(_run('per_step')) is None
    assert run.reader('dispatch_steps_per_s')(_run('per_step')) == 100.0
    assert run.reader('setup_s')(_run('chunked')) == 12.5
    assert run.reader('precompute_s')(_run('chunked')) == 3.0


def test_per_layer_readers():
    ev = [{'ph': 'X', 'cat': 'kernel', 'name': 'fused_render_bwd_kernel',
           'ts': 0.0, 'dur': 80_000.0},
          {'ph': 'X', 'cat': 'kernel', 'name': 'adam', 'ts': 80_000.0,
           'dur': 10_000.0}]
    t = _fake_trace(ev)
    r = _run('chunked', t)                 # 10 ms a step unprofiled
    # busy 90 ms over 10 profiled steps: 9 ms of a 10 ms step
    assert run.reader('device_idle_share.chunked')(r) == pytest.approx(10.0)
    assert run.reader('device_idle_share.per_step')(r) is None
    assert run.reader('loss_update_ms')(r) == pytest.approx(1.0)
    assert run.reader('render_fwd_roofline')(r) is None   # no forward
    flops = 3 * 109_312 * 1000 * 6
    assert run.reader('mfu')(r) == pytest.approx(100 * flops * 100 / 989e12)
    assert run.reader('mfu')(_run('chunked')) is None     # untraced


def test_p95_needs_some_hundreds_of_steps():
    times = [0.008] * 180 + [0.02] * 20
    r = _run('per_step', trace_obj=_fake_trace([]), times=times)
    assert run.reader('dispatch_step_ms_p95')(r) == pytest.approx(20.0)
    short = _run('per_step', trace_obj=_fake_trace([]), times=times[:50])
    assert run.reader('dispatch_step_ms_p95')(short) is None
