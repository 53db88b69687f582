"""95th percentile of every step's synchronized host time in the
unprofiled stretch of the per-step loop, in ms."""
import statistics


def read(run):
    if run.loop != 'per_step' or run.trace is None:
        return None
    times = run.window.step_seconds
    if len(times) < 200:
        return None
    return 1e3 * statistics.quantiles(times, n=100)[94]
