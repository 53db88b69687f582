"""The device trace of a profiled stretch: torch.profiler over CPU and CUDA
activity, exported as a Chrome trace into a temporary file, read back and
reduced to device time by kernel name, busy time (the union of every
kernel, copy and fill on the device) and the idle gaps between them by
what the host was doing."""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'cuda_runtime', 'cuda_driver', 'user_annotation')


class Trace:
    """kernel_s: {name: device seconds}; busy_s: seconds in which some
    operation ran on the device; device_ops / idle_gaps: the ten largest
    [name, seconds] of each."""

    def __init__(self, events):
        dev = sorted((e['ts'], e['ts'] + e.get('dur', 0), e['name'])
                     for e in events if e.get('cat') in DEVICE_CATS)
        self.kernel_s = collections.Counter()
        for a, b, name in dev:
            self.kernel_s[name] += (b - a) * 1e-6
        merged = []
        for a, b, _ in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        host = sorted((e['ts'], e['ts'] + e.get('dur', 0), e['name'])
                      for e in events if e.get('cat') in HOST_CATS)
        starts = [h[0] for h in host]
        gaps = collections.Counter()
        for (_, a), (b, _) in zip(merged, merged[1:]):
            gaps[_doing(host, starts, (a + b) / 2)] += (b - a) * 1e-6
        self.device_ops = [[n[:80], s] for n, s in
                           self.kernel_s.most_common(10)]
        self.idle_gaps = [[n[:80], s] for n, s in gaps.most_common(10)]

    def seconds(self, match):
        """Device seconds of the operations whose name `match` accepts."""
        return sum(s for n, s in self.kernel_s.items() if match(n))


def _doing(host, starts, t):
    """The innermost host operation running at time t, or 'host'."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, 0) - 1, -1):
        if host[j][1] >= t:
            return host[j][2]
    return 'host'


def profile(run):
    """Trace of `run()` under the profiler; the exported file is removed."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        run()
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.unlink(path)
    return Trace([e for e in events if e.get('ph') == 'X'])
