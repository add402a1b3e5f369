"""Small shared utilities.

Reference parity: devito/tools (frozendict, as_tuple, filter_ordered,
memoization, Tag, DAG toposort). Only what this package needs.
"""

import contextlib
from collections import OrderedDict
from functools import wraps

import numpy as np
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = ['as_tuple', 'as_list', 'filter_ordered', 'flatten', 'frozendict',
           'memoized_meth', 'memoized_func', 'Tag', 'prod', 'humanbytes',
           'dtype_of', 'is_integer', 'toposort', 'split', 'powerset',
           'ceil_div', 'round_up', 'span']


def as_tuple(item, length=None):
    """Force *item* to a tuple. None -> (); scalar -> (scalar,)."""
    if item is None:
        t = ()
    elif isinstance(item, (str, bytes)):
        t = (item,)
    else:
        try:
            t = tuple(item)
        except TypeError:
            t = (item,)
    if length is not None:
        if len(t) == 1:
            t = t * length
        elif len(t) != length:
            raise ValueError(f"Expected {length} items, got {len(t)}")
    return t


def as_list(item, length=None):
    return list(as_tuple(item, length))


def filter_ordered(elements, key=None):
    """Remove duplicates preserving order."""
    seen = set()
    out = []
    key = key or (lambda x: x)
    for e in elements:
        k = key(e)
        if k not in seen:
            seen.add(k)
            out.append(e)
    return out


def flatten(items):
    out = []
    for i in items:
        if isinstance(i, (list, tuple)):
            out.extend(flatten(i))
        else:
            out.append(i)
    return out


def split(items, pred):
    """Split *items* into (matching, non-matching) by predicate."""
    yes, no = [], []
    for i in items:
        (yes if pred(i) else no).append(i)
    return yes, no


def powerset(iterable):
    from itertools import chain, combinations
    s = list(iterable)
    return chain.from_iterable(combinations(s, r) for r in range(len(s) + 1))


def prod(iterable, initial=1):
    out = initial
    for i in iterable:
        out *= i
    return out


#: what ``span`` returns while no profiler records: one shared, reentrant
#: context that does nothing
_CLOSED = contextlib.nullcontext()


def span(name):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    records, else a context that does nothing: a range costs host time
    even when no profiler runs, and the time loop opens several a step.
    The program's spans go into the profiler's own trace, on the clock of
    the device's events: ``dtpu::solver.<entry>``, ``dtpu::apply`` and its
    ``.prepare``, ``.loop`` and ``.finish``, the executor's ``dtpu_secN``
    and ``dtpu_exchange``, ``dtpu::sparse.inject`` and ``.interp``,
    ``dtpu::k1.launch`` and ``dtpu::nvcc``."""
    if _profiler_enabled():
        return record_function(name)
    return _CLOSED


def ceil_div(a, b):
    return -(-a // b)


def round_up(x, m):
    return ((x + m - 1) // m) * m


def is_integer(v):
    import sympy
    return isinstance(v, (int, np.integer, sympy.Integer))


def humanbytes(n):
    for unit in ['B', 'KB', 'MB', 'GB', 'TB']:
        if abs(n) < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} PB"


def dtype_of(obj, default=np.float32):
    dtype = getattr(obj, 'dtype', None)
    return np.dtype(dtype) if dtype is not None else np.dtype(default)


class frozendict(dict):
    """An immutable, hashable dict."""

    def __hash__(self):
        return hash(frozenset(self.items()))

    def _blocked(self, *args, **kwargs):
        raise TypeError("frozendict is immutable")

    __setitem__ = __delitem__ = _blocked
    pop = popitem = setdefault = update = clear = _blocked


def memoized_meth(func):
    """Memoize an instance method (cache stored on the instance)."""
    attr = f"_memo_{func.__name__}"

    @wraps(func)
    def wrapper(self, *args, **kwargs):
        cache = getattr(self, attr, None)
        if cache is None:
            cache = {}
            object.__setattr__(self, attr, cache)
        key = (args, tuple(sorted(kwargs.items())))
        try:
            if key in cache:
                return cache[key]
        except TypeError:  # unhashable
            return func(self, *args, **kwargs)
        result = func(self, *args, **kwargs)
        cache[key] = result
        return result
    return wrapper


def memoized_func(func):
    cache = {}

    @wraps(func)
    def wrapper(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        try:
            if key in cache:
                return cache[key]
        except TypeError:
            return func(*args, **kwargs)
        result = func(*args, **kwargs)
        cache[key] = result
        return result
    wrapper.cache = cache
    return wrapper


class Tag:
    """A hashable, named tag (reference: devito/tools/abc.py Tag)."""

    def __init__(self, name, val=None):
        self.name = name
        self.val = val

    def __eq__(self, other):
        return isinstance(other, Tag) and self.name == other.name \
            and self.val == other.val

    def __hash__(self):
        return hash((self.name, self.val))

    def __repr__(self):
        return self.name if self.val is None else f"{self.name}{self.val}"


def toposort(data):
    """Topological sort of a dict node -> set(dependencies). Returns list.

    Deterministic: ties broken by insertion order.
    """
    data = OrderedDict((k, list(v)) for k, v in data.items())
    # Add missing nodes
    for deps in list(data.values()):
        for d in deps:
            if d not in data:
                data[d] = []
    out = []
    emitted = set()
    pending = list(data)
    while pending:
        progressed = False
        remaining = []
        for node in pending:
            if all(d in emitted for d in data[node]):
                out.append(node)
                emitted.add(node)
                progressed = True
            else:
                remaining.append(node)
        if not progressed:
            raise ValueError(f"Cyclic dependency among {remaining}")
        pending = remaining
    return out
