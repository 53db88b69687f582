"""Run one cell of the benchmark once, on the card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the port (`bhnerf_tpu_torch`).
Everything a cell needs is found by name from `BENCHMARK.json`: its
configuration (`benchmark/configs/<config>.json`, built by the kind it
names, `benchmark/kinds/<kind>.py`), its traffic
(`benchmark/traffic/<traffic>.json`), the readers of its metrics
(`benchmark/metrics/<metric>.py`) and the limits of its check
(`benchmark/limits/<config>.json`). The port builds its CUDA kernels
with nvcc at first use into its fixed cache inside the checkout,
`bhnerf_tpu_torch/_build/`, so only the first run in a checkout builds.

A run sets up (the port's tables, ray constants and compaction, the
frame data and weights from the seed, the first three steps, which the
check compares, and one warm-up chunk or a few steps), then measures for
`--seconds`: with `--trace 0` the end-to-end metrics; with `--trace 1` an
unprofiled stretch of that length, then a short stretch under the
profiler, for the per-layer metrics. After the window it compares the
first three steps and the ray constants with the plain reference
(`benchmark/check.py`). The last line of standard output is the result
as one JSON object; the lines before it on standard error give the
device, its clocks and power beside the window, the set-up's phases and,
last, each number of the check beside its limit.

It exits 3 without a result when no CUDA card (or fewer than the cell
asks for) is present, and 4 when JAX, flax or the JAX package is loaded
in the process after the window.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / 'benchmark'
os.environ['USE_FLAX'] = '0'
sys.path.insert(0, str(ROOT))

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'bhnerf_tpu')


def log(msg):
    print(f'# {msg}', file=sys.stderr, flush=True)


def manifest(parked=False):
    """BENCHMARK.json; with `parked`, also the configurations and cells of
    `benchmark/parked.json`, which are built and checked but not measured
    (the CPU tests and `calibrate.py` reach them so)."""
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    if parked:
        extra = json.loads((BENCH / 'parked.json').read_text())
        for key in ('configs', 'workloads'):
            bench[key] = bench[key] + extra[key]
    return bench


def cell_of(bench, name):
    """(workload, configuration dict, traffic dict) of cell `name`."""
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'unknown workload {name!r}; known: '
                         f'{sorted(cells)}')
    cell = cells[name]
    entry = {c['name']: c for c in bench['configs']}[cell['config']]
    cfg = json.loads((ROOT / entry['file']).read_text())
    traffic = json.loads((BENCH / 'traffic' / f'{cell["traffic"]}.json')
                         .read_text())
    return cell, cfg, traffic


def reader(metric):
    """The `read` function of benchmark/metrics/<metric>.py."""
    path = BENCH / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        'benchmark.metrics.' + metric.replace('.', '__'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench, cell, per_layer):
    """The names of the metrics cell `cell` reports: its end-to-end
    metrics, or its per-layer ones."""
    def listed(m):
        return 'workloads' not in m or cell in m['workloads']
    e2e = [m for m in bench['end_to_end'] if listed(m)]
    if not per_layer:
        return e2e
    reported = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if cell in m.get('workloads', [cell])
            and ('workloads' in m or m['moves'] in reported)]


def smi(index=0):
    """nvidia-smi's clocks, power draw and limit, temperature: a string."""
    q = 'name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu'
    try:
        out = subprocess.run(['nvidia-smi', f'--query-gpu={q}',
                              '--format=csv,noheader', f'--id={index}'],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi: {e}'


class Phases(dict):
    """Set-up phases by name, each timed on the host clock ending in a
    synchronize of the card."""

    def __init__(self, device):
        super().__init__()
        self.device = device

    @contextlib.contextmanager
    def __call__(self, name):
        import torch
        t0 = time.perf_counter()
        yield
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self[name] = self.get(name, 0.0) + time.perf_counter() - t0


def forbidden_modules(names=None):
    """The forbidden top-level names among `names` (the loaded modules'
    by default), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    bench = manifest()
    cell, cfg, traffic = cell_of(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        log(f'needs {cell["chips"]} CUDA card(s); found '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 3
    result = run_cell(bench, cell, cfg, traffic, args,
                      torch.device('cuda', 0))
    if result is None:
        return 4
    print(json.dumps(result), flush=True)
    return 0


def run_cell(bench, cell, cfg, traffic, args, device):
    """One run of `cell` on `device`: the result's dict, or None when a
    forbidden module was loaded."""
    import torch
    on_card = device.type == 'cuda'
    name = torch.cuda.get_device_name(device) if on_card else 'cpu'
    log(f'device {name}, '
        f'{torch.cuda.device_count() if on_card else 0} visible, '
        f'{cell["chips"]} used; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}; workload {cell["name"]}, seed {args.seed}, '
        f'{args.seconds:g} s, trace {args.trace}')
    log(f'nvidia-smi before set-up: {smi()}')
    phases = Phases(device)
    with phases('import'):
        kind = importlib.import_module(f'benchmark.kinds.{cfg["kind"]}')
        from bhnerf_tpu_torch.ops import _build
    if on_card:
        with phases('extension_load'):
            for lib in cfg['kernels']:
                _build.load_library(lib)
    fit = kind.build(cfg, traffic, args.seed, device, phases)
    with phases('check_steps'):
        record = fit.check_steps()
    with phases('warm_up'):
        fit.warm_up()
    log('set-up phases (s): ' + ', '.join(f'{k} {v:.4f}'
                                           for k, v in phases.items()))
    log(f'nvidia-smi before the window: {smi()}')
    setup_s = time.time() - T_START
    trace = profiled = None
    step_times = args.trace == 1 and traffic['loop'] == 'per_step'
    window = fit.window(kind.Stop(device, seconds=args.seconds,
                                  step_times=step_times))
    log(f'window: {window.steps} steps in {window.elapsed:.6f} s')
    if traffic['loop'] == 'chunked':
        log('chunks (s): ' + ' '.join(f'{x:.4f}' for x in window.call_seconds))
    log(f'nvidia-smi after the window: {smi()}')
    if args.trace:
        from benchmark import trace as trace_lib
        profiled = kind.Stop(device, max_steps=fit.chunk
                             or traffic['trace_steps'])
        trace = trace_lib.profile(lambda: fit.window(profiled))
        log(f'profiled stretch: {profiled.steps} steps in '
            f'{profiled.elapsed:.6f} s, device busy {trace.busy_s:.6f} s')
    if step_times:
        log(f'dispatch_step_ms_p95 over {len(window.step_seconds)} steps')
    found = forbidden_modules()
    if found:
        log(f'forbidden modules loaded: {found}')
        return None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    work = {'n_eff': fit.in_domain_samples(), 'batch': fit.batch,
            'mlp': (3 * (1 + 2 * cfg['posenc_deg']), cfg['net_depth'],
                    cfg['net_width']),
            'compute_dtype': cfg['compute_dtype']}
    run = types.SimpleNamespace(loop=traffic['loop'], window=window,
                                profiled=profiled, trace=trace,
                                setup_s=setup_s, phases=dict(phases),
                                work=work)
    metrics = {}
    units = {m['name']: m['unit'] for m in
             bench['end_to_end'] + bench['per_layer']}
    for m in metrics_of(bench, cell['name'], args.trace == 1):
        value = reader(m['name'])(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': units[m['name']]}
    fit.free()
    from benchmark import check
    t_check = time.perf_counter()
    values = check.numbers(fit, record, device)
    log(f'check against the reference: {time.perf_counter() - t_check:.2f} s')
    correct, checks = check.verdict(values, check.load_limits(cfg['name']))
    result = {'correct': correct, 'attempted': window.steps, 'failed': 0,
              'metrics': metrics,
              'device': {'platform': 'gpu', 'kind': name,
                         'count': cell['chips'], 'memory_peak_bytes': peak}}
    if trace is not None:
        result['device'].update(busy_s=trace.busy_s,
                                window_s=profiled.elapsed)
        result['breakdown'] = {'device_ops': trace.device_ops,
                               'idle_gaps': trace.idle_gaps}
    result['checks'] = checks
    for k, c in checks.items():
        lim = 'not compared' if c['limit'] is None else f'limit {c["limit"]!r}'
        log(f'check {k} = {c["value"]!r} ({lim})')
    log(f'correct: {correct}')
    return result


if __name__ == '__main__':
    sys.exit(main())
