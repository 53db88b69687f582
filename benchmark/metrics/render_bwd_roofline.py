"""The render backward's share of its roofline: twice the forward's FLOPs
a step (`_work.backward_work`) against the device time a step of
`fused_render_bwd_kernel` and `fused_render_reduce_kernel`."""
from benchmark.metrics import _work


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds(_work.is_backward)
    if not seconds:
        return None
    flops, nbytes = _work.backward_work(run.work)
    return _work.roofline_percent(flops, nbytes,
                                  _work.per_profiled_step(run, seconds),
                                  run.work['compute_dtype'])
