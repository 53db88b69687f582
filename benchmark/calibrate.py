"""The readings that the limits of `benchmark/limits/<config>.json` are set
from, on the card at a cell's own size:

    python3 benchmark/calibrate.py --workload <name> --seed <first> \\
        [--sound 12] [--control 4] [--fault half_batch:3]

For each seed the program is built and its first three steps taken as a
run takes them (no window), and every number of the check is read:

* `sound`: the program as it is (the lower readings);
* `control`: the reference put in the program's place one precision
  below the configuration's float32, TF32 (`reference.nerf`, precision
  'tf32'), and for the table stage the precision below the table's: the
  port's float32 device tracer where the configuration's table is the
  float64 host trace (for the ALMA physics the program's whole ensemble
  traced on the card), else the reference's constants rounded to
  bfloat16;
* a planted fault (`benchmark/faults.py`) under the program's steps.

Prints one JSON line per reading and a summary: the largest sound
reading and the smallest control and fault readings of every number.
"""
from __future__ import annotations

import argparse
import dataclasses
import contextlib
import importlib
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import check, faults, run  # noqa: E402


def control_tables(fit, device):
    """The constants of the table stage's control, as `program(v, px)`."""
    import numpy as np
    import torch
    from benchmark.reference import tables
    cfg = fit.cfg
    if cfg['tracer'] == 'host' and cfg['physics'] == 'alma':
        # the program's own float32 path: its ensemble traced on the card,
        # through its physics, whose B normalisation takes the whole screen
        kind = importlib.import_module(f'benchmark.kinds.{cfg["kind"]}')
        rts = kind._ray_constants(dict(cfg, tracer='device'),
                                  fit.traffic['variants'], fit.seed, device)
        on_card = types.SimpleNamespace(
            cfg=cfg, dense=[kind._host_copy(rt) for rt in rts])
        return lambda v, px: check.program_constants(on_card, v, px)
    if cfg['tracer'] == 'host':
        from bhnerf_tpu_torch import units
        from bhnerf_tpu_torch.geodesics.dataset import trace_geodesics
        from bhnerf_tpu_torch.train import raytracing_args

        def device_trace(v, px):
            a_axis, b_axis = fit.axes[v]
            alpha = np.asarray(a_axis)[px // len(b_axis)]
            beta = np.asarray(b_axis)[px % len(b_axis)]
            geos = trace_geodesics(alpha, beta, cfg['spin'],
                                   np.deg2rad(cfg['inclination_deg']),
                                   ngeo=cfg['ngeo'], n_fine=cfg['n_fine'],
                                   backend='device', device=device)
            rt = raytracing_args(geos, geos.keplerian_omega(),
                                 -float(geos.r_o + cfg['fov_M'] / 4),
                                 units.Quantity(cfg['t_start_obs'], 'hr'),
                                 device=device)
            out = {k: np.asarray(getattr(rt, k).cpu(), np.float64)
                   for k in ('coords', 'Omega', 'g', 'dtau', 'Sigma',
                             't_geos_rel')}
            out['J'] = np.ones((1,) + out['g'].shape)
            return out
        return device_trace

    def rounded(v, px):
        a_axis, b_axis = fit.axes[v]
        ref = tables.ray_constants(cfg, a_axis, b_axis, px)
        return {k: torch.as_tensor(x).to(torch.bfloat16).double().numpy()
                for k, x in ref.items()}
    return rounded


def readings(fit, record, device):
    return {**check.step_numbers(fit, record, check.reference_steps(
        fit, record, device)), **check.table_numbers(fit, record)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--sound', type=int, default=12)
    p.add_argument('--control', type=int, default=4)
    p.add_argument('--fault', action='append', default=[],
                   help='name:seeds, e.g. half_batch:3')
    args = p.parse_args(argv)
    import torch
    bench = run.manifest(parked=True)
    cell, cfg, traffic = run.cell_of(bench, args.workload)
    return calibrate(args, cfg, traffic, torch.device('cuda', 0))


def calibrate(args, cfg, traffic, device):
    kind = importlib.import_module(f'benchmark.kinds.{cfg["kind"]}')
    span = lambda name: contextlib.nullcontext()
    out = {}

    def keep(label, seed, values):
        print(json.dumps({'kind': label, 'seed': seed, **values}),
              flush=True)
        out.setdefault(label, []).append(values)

    for i in range(max(args.sound, args.control)):
        seed = args.seed + i
        fit = kind.build(cfg, traffic, seed, device, span)
        record = fit.check_steps()
        fit.free()
        if i < args.sound:
            keep('sound', seed, readings(fit, record, device))
        if i < args.control:
            ref = check.reference_steps(fit, record, device)
            ctl = check.reference_steps(fit, record, device, 'tf32')
            as_program = dataclasses.replace(
                record, losses=ctl[0], grad1=ctl[1], params3=ctl[2])
            keep('control', seed, {
                **check.step_numbers(fit, as_program, ref),
                **check.table_numbers(fit, record,
                                      control_tables(fit, device))})
    for spec in args.fault:
        name, n = spec.split(':')
        for i in range(int(n)):
            seed = args.seed + 100 + i
            fit = kind.build(cfg, traffic, seed, device, span)
            with faults.FAULTS[name]():
                record = fit.check_steps()
            fit.free()
            keep(name, seed, readings(fit, record, device))
    summary = {}
    for label, rows in out.items():
        pick = max if label == 'sound' else min
        summary[label] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({'summary': summary, 'config': cfg['name']}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
