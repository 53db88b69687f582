"""The yardstick's arithmetic, shared by the metric readers: the work a
step of a NeRF fit needs by the algorithm, and the card's published peaks.

`mlp_flops_per_sample` is a frozen copy of `bhnerf_tpu_torch/bench.py`
lines 71-83 (2 * K * N per layer at the true widths, the skip's extra
input included); the peaks are NVIDIA's data sheet for the H100 SXM
(dense tensor-core rates, no sparsity, at its 700 W limit) and the
convention of `bench.py` lines 55-59 (`PEAK_FLOPS`, the bf16 rate) for
the whole step's share.
"""
from __future__ import annotations

PEAK_FLOPS = {'float32': 495e12,     # TF32 tensor cores
              'bfloat16': 989e12}
STEP_PEAK_FLOPS = 989e12            # dense bf16, whatever the dtype
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def mlp_dims(feature_dim, depth, width, out=1, do_skip=True):
    dims, d = [], feature_dim
    for i in range(depth):
        dims.append((d, width))
        d = width
        if do_skip and i > 0 and i % (depth // 2) == 0:
            d += feature_dim
    dims.append((d, out))
    return dims


def mlp_flops_per_sample(feature_dim, depth, width, out=1, do_skip=True):
    """Forward matmul FLOPs of one sample: 2 * K * N per layer."""
    return 2 * sum(k * n for k, n in mlp_dims(feature_dim, depth, width,
                                              out, do_skip))


def mlp_params(feature_dim, depth, width, out=1, do_skip=True):
    return sum((k + 1) * n for k, n in mlp_dims(feature_dim, depth, width,
                                                out, do_skip))


def forward_work(w):
    """(FLOPs, bytes) of one step's render forward: the MLP over every
    in-domain sample of every frame; reading each sample's position,
    angular velocity and time once, the frame times and the weights,
    and writing each emission once."""
    n, f = w['n_eff'], w['batch']
    flops = mlp_flops_per_sample(*w['mlp']) * n * f
    nbytes = F32 * (5 * n + f + mlp_params(*w['mlp']) + f * n)
    return flops, nbytes


def backward_work(w):
    """(FLOPs, bytes) of the render backward: twice the forward's
    products (the gradients of the activations and of the weights);
    reading the samples, the emission's cotangent and the weights once,
    writing each weight's gradient once."""
    n, f = w['n_eff'], w['batch']
    flops = 2 * mlp_flops_per_sample(*w['mlp']) * n * f
    nbytes = F32 * (5 * n + f + 2 * mlp_params(*w['mlp']) + f * n)
    return flops, nbytes


def roofline_percent(flops, nbytes, seconds, dtype):
    """The least time the card could take (the larger of the compute and
    the memory bound) over the time taken, in percent."""
    bound = max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
    return 100.0 * bound / seconds


def is_forward(name):
    """The render forward's kernels (the profiler gives the demangled
    signature, `void (anonymous namespace)::fused_render_fwd_kernel...`)."""
    return 'fused_render_fwd' in name


def is_backward(name):
    return 'fused_render_bwd' in name or 'fused_render_reduce' in name


def step_seconds(run):
    """Seconds a step in the unprofiled stretch of a traced run."""
    return run.window.elapsed / run.window.steps


def per_profiled_step(run, seconds):
    return seconds / run.profiled.steps


def idle_percent(run, loop):
    """1 - device busy a step under the profiler / a step's time
    unprofiled, in percent; None off `loop` or without a trace."""
    if run.trace is None or run.loop != loop:
        return None
    busy = per_profiled_step(run, run.trace.busy_s)
    return 100.0 * (1.0 - busy / step_seconds(run))
