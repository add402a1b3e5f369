"""Reads a torch.profiler Chrome trace of a run's traced jobs.

Device events are the trace's GPU kernels, memory copies and memsets.
Each gets a category by its name, from a frozen copy of the program's own
table (``operator/trace_profile.py`` ``CATEGORIES``, copied here so that a
change to the program cannot change the yardstick):

    stencil     K1's kernels (``dtpu::stencil_kernel``, ``dtpu::stream_kernel``)
    scatter     index_put_'s accumulating kernels (the injection)
    gather      index and gather kernels (the interpolation's corners)
    copy        memcpy, memset, copy and fill kernels
    elementwise every other torch elementwise or reduction kernel
    other       anything else

The traced window runs from the start of the first ``gpubench::job``
span to the end of the last. The device is idle in the gaps that the
union of its events' intervals leaves in the window, and busy for the
rest: overlapping events (two streams) count once.
"""

import heapq
import json
from collections import OrderedDict

__all__ = ['CATEGORIES', 'category', 'Trace', 'JOB_SPAN']

CATEGORIES = OrderedDict([
    ('stencil', ('dtpu::stencil_kernel', 'dtpu::stream_kernel')),
    ('scatter', ('index_put', 'indexing_backward', 'scatter')),
    ('gather', ('index_elementwise', 'index_select', 'gather',
                'index_kernel')),
    ('copy', ('memcpy', 'memset', 'copy', 'fillfunctor')),
    ('elementwise', ('elementwise_kernel', 'reduce_kernel')),
])

#: the benchmark's span around each job
JOB_SPAN = 'gpubench::job'

_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
_HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')


def category(name):
    """The category of the device event ``name`` (see the module)."""
    k = name.lower()
    for cat, keys in CATEGORIES.items():
        if any(s in k for s in keys):
            return cat
    return 'other'


class Trace:
    """The traced window of one Chrome trace (its parsed JSON)."""

    def __init__(self, events):
        jobs = [e for e in events if e.get('ph') == 'X' and
                e.get('name') == JOB_SPAN and e.get('dur') is not None]
        self.jobs = len(jobs)
        if not jobs:
            self.lo = self.hi = 0.0
            self.device, self.host = [], []
            return
        self.lo = min(float(e['ts']) for e in jobs)
        self.hi = max(float(e['ts']) + float(e['dur']) for e in jobs)
        self.device = []
        for e in events:
            if e.get('ph') != 'X' or e.get('cat') not in _DEVICE_CATS or \
                    e.get('dur') is None:
                continue
            a = float(e['ts'])
            b = a + float(e['dur'])
            if b > self.lo and a < self.hi:
                self.device.append((e['name'], category(e['name']),
                                    max(a, self.lo), min(b, self.hi)))
        self.host = sorted(
            (float(e['ts']), float(e['ts']) + float(e['dur']), e['name'],
             e.get('cat'))
            for e in events if e.get('ph') == 'X' and
            e.get('cat') in _HOST_CATS and e.get('dur') is not None)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f).get('traceEvents', []))

    @property
    def window_s(self):
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self):
        """Seconds of the window in which some device event ran."""
        return self.window_s - sum(b - a for a, b in self.gaps()) * 1e-6

    def seconds(self, categories=None, exclude=()):
        """Device seconds (summed) of the events in ``categories`` (all by
        default), less those in ``exclude``."""
        return sum((b - a) * 1e-6 for _, c, a, b in self.device
                   if (categories is None or c in categories) and
                   c not in exclude)

    def device_ops(self, n=10):
        """The ``n`` device operations that took most time: [[name,
        seconds]], longest first."""
        tot = {}
        for name, _, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def gaps(self):
        """The idle intervals (start, end) of the window, in microseconds:
        where no device event runs."""
        out, end = [], self.lo
        for a, b in sorted((a, b) for _, _, a, b in self.device):
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.hi > end:
            out.append((end, self.hi))
        return out

    def idle_gaps(self, n=10):
        """The idle time of the window by what the host was doing at the
        middle of each gap, named '<benchmark span>/<innermost host
        operation>': [[what, seconds]], the ``n`` largest."""
        tot, active, i = {}, [], 0
        for a, b in sorted(self.gaps(), key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(self.host) and self.host[i][0] <= mid:
                heapq.heappush(active, (self.host[i][1], i))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            span = inner = None
            for _, j in active:
                s, e, name, cat = self.host[j]
                if cat == 'user_annotation' and name.startswith('gpubench::'):
                    if span is None or e - s < span[0]:
                        span = (e - s, name)
                elif inner is None or e - s <= inner[0]:
                    inner = (e - s, name)
            what = '/'.join(p[1] for p in (span, inner) if p is not None)
            what = what or 'no host span'
            tot[what] = tot.get(what, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]
