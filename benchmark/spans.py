"""The readers of the program's spans (`bhnerf_tpu_torch.tracing`), for the
per-layer metrics that only the spans inside the port can give, and the
device's idle time by program span (`idle_by_span`).

`benchmark/run.py` leaves spans off, so no entry of BENCHMARK.json reads
these yet. Each reader takes a run as run.py builds it, with two things
more: `run.spans`, the program's span records (`tracing.records()`) taken
at the end of set-up, of the unprofiled window and of the profiled
stretch, keyed 'setup', 'window' and 'profiled'; and
`run.trace.idle_by_span`, `idle_by_span` of the profiled stretch's
events. A reader returns None on a run without them, or of the other
loop.
"""
from __future__ import annotations

import collections
import statistics

from benchmark import trace as trace_lib

PREFIX = 'bhnerf.'


def idle_by_span(events):
    """Device idle seconds between the device's operations in a chrome
    trace's events, by the innermost program span (a `bhnerf.`
    user_annotation) covering each gap's midpoint, or 'none'."""
    dev = sorted((e['ts'], e['ts'] + e.get('dur', 0)) for e in events
                 if e.get('cat') in trace_lib.DEVICE_CATS)
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((a + b) / 2, b - a)
                  for (_, a), (b, _) in zip(merged, merged[1:]))
    spans = sorted((e['ts'], e['ts'] + e.get('dur', 0), e['name'])
                   for e in events if e.get('cat') == 'user_annotation'
                   and e.get('name', '').startswith(PREFIX))
    out = collections.Counter()
    stack, i = [], 0         # the spans open at time t, innermost last
    for t, width in gaps:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[stack[-1][2] if stack else 'none'] += width * 1e-6
    return out


def _ns(r):
    return r.end_ns - r.start_ns


def _records(run, stretch):
    return getattr(run, 'spans', {}).get(stretch)


def step_host_ms(run):
    """Median over the window's steps of the per-step loop of a
    `bhnerf.loop.step` span less its `bhnerf.loop.callbacks` child, in a
    traced run, whose Stop there waits for the card after every step: the
    host's own cost of a step started on an idle card."""
    recs = _records(run, 'window')
    if run.loop != 'per_step' or run.profiled is None or not recs:
        return None
    callbacks = collections.Counter()
    for r in recs:
        if r.name == 'bhnerf.loop.callbacks':
            callbacks[r.parent] += _ns(r)
    ms = [(_ns(r) - callbacks[r.id]) * 1e-6 for r in recs
          if r.name == 'bhnerf.loop.step']
    return statistics.median(ms) if ms else None


def chunk_boundary_ms(run):
    """Median over the window's chunk boundaries of the host ms from the
    end of a `bhnerf.loop.guard` to the start of the next chunk's first
    `bhnerf.step.*` span."""
    recs = _records(run, 'window')
    if run.loop != 'chunked' or not recs:
        return None
    ms, guard_end = [], None
    for r in sorted(recs, key=lambda r: r.start_ns):
        if r.name == 'bhnerf.loop.guard':
            guard_end = r.end_ns
        elif guard_end is not None and r.name.startswith('bhnerf.step.'):
            ms.append((r.start_ns - guard_end) * 1e-6)
            guard_end = None
    return statistics.median(ms) if ms else None


def _idle_ms(run, prefix):
    idle = getattr(getattr(run, 'trace', None), 'idle_by_span', None)
    if run.loop != 'per_step' or idle is None:
        return None
    seconds = sum(s for n, s in idle.items() if n.startswith(prefix))
    return 1e3 * seconds / run.profiled.steps


def idle_loop_ms(run):
    """Profiled device idle ms a step of the per-step loop under a
    `bhnerf.loop.*` span innermost."""
    return _idle_ms(run, 'bhnerf.loop.')


def idle_step_ms(run):
    """The same under a `bhnerf.step.*` span innermost."""
    return _idle_ms(run, 'bhnerf.step.')


def geodesics_s(run):
    """Seconds of set-up's `bhnerf.precompute.geodesics` spans."""
    ns = [_ns(r) for r in _records(run, 'setup') or ()
          if r.name == 'bhnerf.precompute.geodesics']
    return sum(ns) * 1e-9 if ns else None


READERS = {'step_host_ms': step_host_ms,
           'chunk_boundary_ms': chunk_boundary_ms,
           'idle_loop_ms.per_step': idle_loop_ms,
           'idle_step_ms.per_step': idle_step_ms,
           'geodesics_s': geodesics_s}
