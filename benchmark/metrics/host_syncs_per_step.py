"""Host synchronisations a step of the per-step loop, as the program counts
them (`bhnerf_tpu_torch.tracing.counters`, the keys `host_syncs.<site>`).

A whole-run figure: the counters always count, and run.py takes no copy
of them at the window's edges, so this is every sync the process counted
over every optimizer step it took (the three checked steps, the warm-up,
the window and the profiled stretch), read after the run. It becomes the
unprofiled window's own figure once the harness hands the readers copies
of the counters at the window's edges. None for a program without these
counters."""


def read(run):
    if run.loop != 'per_step' or run.profiled is None:
        return None
    try:
        from bhnerf_tpu_torch.tracing import counters
    except ImportError:
        return None
    syncs = sum(n for k, n in counters.counts.items()
                if k.startswith('host_syncs.'))
    return syncs / (run.profiled.step0 + run.profiled.steps)
