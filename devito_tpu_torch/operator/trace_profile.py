"""Measured per-section device times from a ``torch.profiler`` trace.

Ports devito_tpu/operator/trace_profile.py (reference analog: per-Section
C timers, devito/passes/iet/instrument.py:16). Under ``profiling=
'measured'`` (or a ``profile-dir``) ``Operator.apply`` runs its loop
under ``torch.profiler`` with the executor tagging each body item with a
``record_function('dtpu_secN')`` range, and writes the Chrome trace into
the directory; this module reads it back.

Device events are the GPU kernels, memory copies and memsets of the trace.
A device event belongs to the ``dtpu_secN`` range that encloses it (or to
``dtpu_exchange``, the range of a sharded run's halo exchange markers,
parallel/halo.py): the
``gpu_user_annotation`` range torch.profiler draws on the device's
timeline, or else the CPU ``user_annotation`` range that holds the
runtime call which launched it, found by the two events' ``correlation``.
An event whose launch lies outside every range counts as outside the
sections ("other"). An event that neither a device range holds nor a
correlation links to its launch (torch.profiler can drop events) is
counted apart, as unattributed, and its time goes to other: it is never
guessed into a section.

Categories are the port's own, by event name: ``stencil`` (K1's units,
``dtpu::stencil_kernel`` and ``dtpu::stream_kernel``), ``scatter``
(``index_put_``'s accumulating kernels), ``gather`` (index and gather
kernels), ``copy`` (memcpy, memset, copy and fill kernels),
``elementwise`` (the torch translator's kernels) and ``other``.
"""

import glob
import gzip
import json
import os
import re
from collections import OrderedDict

__all__ = ['device_events', 'device_op_durations', 'section_durations',
           'attribute', 'section_events', 'categorize_ops', 'CATEGORIES']

#: category -> lower-case substrings of a device event's name, tried in
#: this order (an index kernel is named ``index_elementwise_kernel``, a
#: copy ``elementwise_kernel<... direct_copy_kernel ...>``).
CATEGORIES = OrderedDict([
    ('stencil', ('dtpu::stencil_kernel', 'dtpu::stream_kernel')),
    ('scatter', ('index_put', 'indexing_backward', 'scatter')),
    ('gather', ('index_elementwise', 'index_select', 'gather',
                'index_kernel')),
    ('copy', ('memcpy', 'memset', 'copy', 'fillfunctor')),
    ('elementwise', ('elementwise_kernel', 'reduce_kernel')),
])

#: Trace-event categories of device work.
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
#: Host events that launch device work.
_LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
_TAG = re.compile(r'^dtpu_(sec\d+|exchange)$')


def _category(name):
    k = name.lower()
    for cat, keys in CATEGORIES.items():
        if any(s in k for s in keys):
            return cat
    return 'other'


def _trace_events(trace_dir):
    """The events of the newest torch.profiler Chrome trace under
    ``trace_dir`` (``*.pt.trace.json``, gzipped or not), or None."""
    paths = [p for pat in ('*.pt.trace.json', '*.pt.trace.json.gz')
             for p in glob.glob(os.path.join(trace_dir, '**', pat),
                                recursive=True)]
    if not paths:
        return None
    path = max(paths, key=lambda p: (os.path.getmtime(p), p))
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        return json.load(f).get('traceEvents', [])


def _device(evs):
    return [e for e in evs if e.get('ph') == 'X' and
            e.get('cat') in _DEVICE_CATS and e.get('dur') is not None]


def device_events(trace_dir):
    """Device events ``[(name, seconds, args)]`` of the newest trace under
    ``trace_dir``, or None when there is no trace or it holds no device
    event (a CPU run records none)."""
    evs = _trace_events(trace_dir)
    if evs is None:
        return None
    out = [(e['name'], float(e['dur']) * 1e-6, e.get('args') or {})
           for e in _device(evs)]
    return out or None


def device_op_durations(trace_dir):
    """Total busy seconds per device event name ({name: seconds}), or
    None (see device_events)."""
    evs = device_events(trace_dir)
    if evs is None:
        return None
    out = {}
    for name, secs, _ in evs:
        out[name] = out.get(name, 0.0) + secs
    return out


def _ranges(evs, cat):
    """{(pid, tid): [(start, end, name)]} of the ``dtpu_secN`` ranges of
    trace category ``cat``."""
    out = {}
    for e in evs:
        if e.get('ph') == 'X' and e.get('cat') == cat and \
                _TAG.match(str(e.get('name', ''))):
            ts = float(e['ts'])
            out.setdefault((e.get('pid'), e.get('tid')), []).append(
                (ts, ts + float(e.get('dur', 0)), e['name']))
    return out


def _enclosing(ranges, key, a, b):
    """The name of the shortest range of ``ranges[key]`` holding [a, b],
    or None."""
    best = None
    for s, t, name in ranges.get(key, ()):
        if s <= a and b <= t and (best is None or t - s < best[0]):
            best = (t - s, name)
    return None if best is None else best[1]


def section_events(trace_dir):
    """Each device event of the newest trace under ``trace_dir`` with its
    section: ``[(section or None, category, start us, end us, stream,
    unattributed)]`` (section None: outside every section, or
    unattributed: no range holds it and no correlation links it to its
    launch), or None when there is no device event. The stream is the
    trace's thread of the event."""
    evs = _trace_events(trace_dir)
    if evs is None:
        return None
    dev = _device(evs)
    if not dev:
        return None
    gpu = _ranges(evs, 'gpu_user_annotation')
    cpu = _ranges(evs, 'user_annotation')
    launch = {}
    for e in evs:
        corr = (e.get('args') or {}).get('correlation')
        if e.get('ph') == 'X' and e.get('cat') in _LAUNCH_CATS and \
                corr is not None:
            launch[corr] = e
    out = []
    for e in dev:
        a = float(e['ts'])
        b = a + float(e['dur'])
        name = _enclosing(gpu, (e.get('pid'), e.get('tid')), a, b)
        lost = False
        if name is None:
            r = launch.get((e.get('args') or {}).get('correlation'))
            if r is None:
                lost = True
            else:
                t = float(r['ts'])
                name = _enclosing(cpu, (r.get('pid'), r.get('tid')), t, t)
        out.append((name, _category(e['name']), a, b, e.get('tid'), lost))
    return out


def attribute(trace_dir):
    """Each device event of the newest trace under ``trace_dir`` given to
    its section (see the module's docstring): ``{'sections': {'dtpu_secN':
    seconds}, 'other': seconds outside every section, unattributed ones
    included, 'unattributed': their count, 'unattributed_s': their
    seconds, 'events': the device events' count}``, or None when there is
    no device event."""
    evs = section_events(trace_dir)
    if evs is None:
        return None
    secs, other, lost, lost_s = {}, 0.0, 0, 0.0
    for name, _, a, b, _, unattributed in evs:
        secs_ = (b - a) * 1e-6
        if unattributed:
            lost += 1
            lost_s += secs_
        if name is None:
            other += secs_
        else:
            secs[name] = secs.get(name, 0.0) + secs_
    return {'sections': secs, 'other': other, 'unattributed': lost,
            'unattributed_s': lost_s, 'events': len(evs)}


def section_durations(trace_dir):
    """Measured busy seconds per schedule section: ({'dtpu_secN':
    seconds} or None, seconds outside every section), or (None, 0.0) when
    the trace holds no device event."""
    res = attribute(trace_dir)
    if res is None:
        return None, 0.0
    return (res['sections'] or None), res['other']


def categorize_ops(durations):
    """{event name: seconds} -> OrderedDict {category: seconds}, every
    category present, zero-filled."""
    cats = OrderedDict((c, 0.0) for c in CATEGORIES)
    cats['other'] = 0.0
    for name, secs in durations.items():
        cats[_category(name)] += secs
    return cats
