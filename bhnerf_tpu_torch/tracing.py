"""Spans and counters of bhnerf_tpu_torch.

Spans time the program's layers from the inside: the training loop
(`bhnerf.loop.*`), a gradient step (`bhnerf.step.*`), the precompute
(`bhnerf.precompute.*`), set-up (`bhnerf.setup.*`) and kernel loads
(`bhnerf.kernels.load`). They are off by default, and then `span(name)`
costs one flag check and returns a shared no-op context manager. After
`enable()` each span appends one record to an in-memory list: its id,
name, start and end (`time.perf_counter_ns()`), the id of the span that
encloses it, and the training step it serves (the step, or a chunk's
first step; None outside `Optimizer.run`). While a `torch.profiler`
session is active a span also opens `torch.profiler.record_function`, so
it lands in the exported trace as a `user_annotation` on the clock of
the device's kernels. `records()` takes the finished records and
`summary(records)` sums them by name. `train.logging.profile_trace`
turns spans on for its scope. No span or counter synchronises the card
or reads a device tensor. Spans are recorded from one thread, the one
that drives the training loop.

Counters always count: `counters` is a `Census` of the training loop's
host synchronisations (`host_syncs.<site>`), its copies of frame indices
from the host (`h2d.<site>`, with their bytes as the total), the
kernel loads and builds (`kernels.loaded`, `kernels.built`) and each
render backward by its path (`render_bwd.from_stash`,
`render_bwd.recomputed`, counted by `ops.fused.render_bwd`). A mesh
counts its collectives in a `Census` of its own
(`parallel.mesh.Mesh.census`). Kernel launches are counted on the
kernels' wrappers (`ops.fused.render_fwd.launches`, `.render_bwd.launches`,
`geodesics.integrator.trace_rays.launches`).
"""
from __future__ import annotations

import collections
import functools
import itertools
import time

import torch

Record = collections.namedtuple('Record',
                                'id name start_ns end_ns parent step')

_on = False
_records = []       # [id, name, start_ns, end_ns, parent, step], by start
_open = []          # the records of the open spans, innermost last
_ids = itertools.count()
_step = None


class Census:
    """Counts by key, with the total and the largest of the values added
    under each key."""

    def __init__(self):
        self.counts = {}
        self.totals = {}
        self.largest = {}

    def add(self, key, value=0):
        self.counts[key] = self.counts.get(key, 0) + 1
        self.totals[key] = self.totals.get(key, 0) + value
        self.largest[key] = max(self.largest.get(key, 0), value)

    def reset(self):
        self.counts.clear()
        self.totals.clear()
        self.largest.clear()

    def copy(self):
        out = Census()
        out.counts, out.totals, out.largest = (dict(self.counts),
                                               dict(self.totals),
                                               dict(self.largest))
        return out

    def as_dict(self):
        """{key: {'count': n, 'largest': value}}, by key."""
        return {k: {'count': n, 'largest': self.largest[k]}
                for k, n in sorted(self.counts.items())}


counters = Census()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ('_rec', '_rf')

    def __init__(self, name):
        self._rec = [next(_ids), name, None, None,
                     _open[-1][0] if _open else None, _step]
        self._rf = None

    def __enter__(self):
        rec = self._rec
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(rec[1])
            self._rf.__enter__()
        _records.append(rec)
        _open.append(rec)
        rec[2] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._rec[3] = time.perf_counter_ns()
        _open.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name):
    """A context manager that records the span `name` while spans are on,
    and does nothing otherwise."""
    if not _on:
        return _OFF
    return _Span(name)


def traced(name):
    """A decorator that runs the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def at_step(step):
    """Mark the spans opened from here on as serving training step
    `step` (None: none)."""
    global _step
    _step = step


def enable():
    """Turn spans on; returns whether they were on already."""
    global _on
    was, _on = _on, True
    return was


def disable():
    global _on
    _on = False


def records():
    """Take the finished records (`Record`s, by start); spans still open
    stay to be taken later."""
    done = [Record(*r) for r in _records if r[3] is not None]
    _records[:] = [r for r in _records if r[3] is None]
    return done


def summary(recs):
    """{name: {'count', 'total_ms', 'self_ms'}} of `recs`, by total; a
    span's self time is its duration less that of its child spans among
    `recs`."""
    child_ns = collections.Counter()
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] += r.end_ns - r.start_ns
    out = {}
    for r in recs:
        s = out.setdefault(r.name, {'count': 0, 'total_ms': 0.0,
                                    'self_ms': 0.0})
        s['count'] += 1
        s['total_ms'] += (r.end_ns - r.start_ns) * 1e-6
        s['self_ms'] += (r.end_ns - r.start_ns - child_ns[r.id]) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]['total_ms']))
