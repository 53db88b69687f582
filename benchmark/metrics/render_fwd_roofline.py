"""The render forward's share of its roofline: the algorithm's FLOPs and
bytes a step (`_work.forward_work`) against the device time a step of
`fused_render_fwd_pack_kernel` and `fused_render_fwd_kernel`."""
from benchmark.metrics import _work


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds(_work.is_forward)
    if not seconds:
        return None
    flops, nbytes = _work.forward_work(run.work)
    return _work.roofline_percent(flops, nbytes,
                                  _work.per_profiled_step(run, seconds),
                                  run.work['compute_dtype'])
