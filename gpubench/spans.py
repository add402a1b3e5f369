"""The program's own spans in a traced window, for the per-layer readers
that read them.

While a profiler records, the program opens host ranges at its layer
boundaries (``devito_tpu_torch/utils/tools.py`` ``span``): ``dtpu::solver.
<entry>``, ``dtpu::apply`` with ``.prepare``, ``.loop`` and ``.finish``, the
executor's ``dtpu_secN``, ``dtpu::sparse.inject`` and ``.interp``,
``dtpu::k1.launch`` and ``dtpu::nvcc``. They are ``user_annotation`` events of
``Trace.host``, on the clock of the device's events.

Every interval here is in the trace's microseconds, clipped to the traced
window; a set of intervals is a sorted list of disjoint ones (a union), so
nested or overlapping spans count once.
"""

import bisect

__all__ = ['PREFIX', 'named', 'runtime', 'union', 'measure', 'intersect',
           'covers']

#: the prefix of every span the program opens
PREFIX = 'dtpu'

_RUNTIME_CATS = ('cuda_runtime', 'cuda_driver')


def _clipped(tr, events):
    out = []
    for a, b in events:
        a, b = max(a, tr.lo), min(b, tr.hi)
        if b > a:
            out.append((a, b))
    return out


def named(tr, match):
    """The program's spans in ``tr``'s window whose name ``match(name)``
    accepts (or equals ``match``, a string): a list of (start, end), one a
    span, clipped to the window."""
    if isinstance(match, str):
        match = match.__eq__
    return _clipped(tr, ((a, b) for a, b, n, cat in tr.host
                         if cat == 'user_annotation' and match(n)))


def runtime(tr):
    """The union of the CUDA runtime and driver calls in ``tr``'s window."""
    return union(_clipped(tr, ((a, b) for a, b, _, cat in tr.host
                               if cat in _RUNTIME_CATS)))


def union(intervals):
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def measure(u):
    """The length of a union."""
    return sum(b - a for a, b in u)


def intersect(u, v):
    """The intersection of two unions, a union."""
    out, i, j = [], 0, 0
    while i < len(u) and j < len(v):
        a, b = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        if b > a:
            out.append((a, b))
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return out


def covers(u, x):
    """Whether the union ``u`` holds the point ``x``."""
    i = bisect.bisect_right(u, (x, float('inf'))) - 1
    return i >= 0 and u[i][0] <= x <= u[i][1]
