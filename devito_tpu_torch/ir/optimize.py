"""Symbolic optimization passes over the lowered Schedule.

Reference parity: the cluster-level flop-reduction passes -- Lift
(devito/passes/clusters/misc.py:13, hoist dimension-invariant clusters out
of loops) and CIRE mode 'invariants' (devito/passes/clusters/aliases.py:34,
extract time-invariant aliasing subexpressions into Array temporaries).

A hoisted invariant replaces per-step arithmetic (divisions,
transcendentals, polynomial chains over model parameter fields) with one
extra stream read of a temporary computed once in the prologue. The cost
model and its thresholds are devito_tpu's (ir/optimize.py), kept as they
are so that both packages build the same schedule: hoist when the
subexpression contains an expensive op (division / sqrt / transcendental)
or enough arithmetic that one stream read is cheaper than recomputation.
"""

import itertools

import numpy as np
import sympy

from ..types.basic import AbstractFunction, retrieve_functions
from .lowering import (LoweredEq, _has_time, estimate_cost)

__all__ = ['hoist_invariants']

_ctr = itertools.count()

_EXPENSIVE = (sympy.sin, sympy.cos, sympy.tan, sympy.exp, sympy.log,
              sympy.sinh, sympy.cosh, sympy.tanh, sympy.asin, sympy.acos,
              sympy.atan)

# A hoisted temporary costs one extra stream read per step. These weights
# and the threshold were set on a TPU (devito_tpu ir/optimize.py, against
# its measured stream and op costs) and are kept as they are so that this
# package's schedules match devito_tpu's; whether they suit the H100 is an
# open question (PERF.md). Hoist only candidates whose weighted per-point
# cost clearly beats the stream price.
_WEIGHTED_MIN = 13
_W_DIVISION = 2
_W_TRANSCENDENTAL = 12


def _raw_cost(expr):
    """Plain op count (every node = 1 op). The hoisting thresholds were
    set against THIS counting; the reporting-side ``estimate_cost``
    (ir/lowering.py) weights divisions/transcendentals instead -- keep the
    two decoupled."""
    flops = 0

    def _walk(e):
        nonlocal flops
        if isinstance(e, AbstractFunction):
            return
        if not isinstance(e, sympy.Basic) or not e.args:
            return
        if isinstance(e, (sympy.Add, sympy.Mul)):
            flops += len(e.args) - 1
        elif isinstance(e, sympy.Pow):
            flops += 1
        elif isinstance(e, sympy.Function):
            flops += 1
        for a in e.args:
            _walk(a)

    _walk(sympy.sympify(expr))
    return flops


def _dense_accesses(expr):
    return [a for a in retrieve_functions(expr)
            if not a.function.is_SparseFunction
            and a.function.grid is not None]


def _weighted_cost(expr):
    cost = _raw_cost(expr)
    for node in sympy.preorder_traversal(sympy.sympify(expr)):
        if isinstance(node, sympy.Pow):
            e = node.exp
            if (getattr(e, 'is_number', False) and
                    (not float(e).is_integer() or float(e) < 0)):
                cost += _W_DIVISION
        elif isinstance(node, _EXPENSIVE):
            cost += _W_TRANSCENDENTAL
    return cost


def _worthwhile(expr):
    if not _dense_accesses(expr):
        return False  # scalar-only: folded at trace time anyway
    return _weighted_cost(expr) >= _WEIGHTED_MIN


def _invariant(expr, body_written=()):
    if _has_time(expr):
        return False
    # timeless functions WRITTEN in the loop body (CIRE temporaries) are
    # not invariant either
    for a in retrieve_functions(expr):
        if a.function.name in body_written:
            return False
    return True


def _collect(expr, out, body_written=()):
    """Top-down collection of maximal hoistable invariant subexpressions."""
    expr = sympy.sympify(expr)
    if not getattr(expr, 'args', ()):
        return
    if _invariant(expr, body_written):
        if _worthwhile(expr):
            out[expr] = True
        return  # whole subtree invariant: either hoisted or too cheap
    if isinstance(expr, (sympy.Add, sympy.Mul)):
        inv = [a for a in expr.args if _invariant(a, body_written)]
        if inv:
            group = expr.func(*inv, evaluate=False) if len(inv) > 1 else inv[0]
            if _worthwhile(group):
                out[group] = True
                # don't descend into the hoisted group
                for a in expr.args:
                    if not _invariant(a, body_written):
                        _collect(a, out, body_written)
                return
    for a in expr.args:
        _collect(a, out, body_written)


def _shifted_trig_blowup_bytes(body_dense, body_written):
    """The 'auto' rule's measure of the body's shifted invariant
    transcendentals: 4 bytes a grid point for each DISTINCT (func, field,
    offset) node. devito_tpu takes it as the buffers XLA's loop-invariant
    code motion would materialize; this package has no such motion, and
    keeps the rule so that its schedules match devito_tpu's."""
    seen = set()
    total = 0
    for eq in body_dense:
        for node in sympy.preorder_traversal(sympy.sympify(eq.rhs)):
            if not isinstance(node, _EXPENSIVE) or len(node.args) != 1:
                continue
            a = node.args[0]
            fn = getattr(a, 'function', None)
            if fn is None or getattr(fn, 'is_SparseFunction', False) \
                    or getattr(fn, 'grid', None) is None:
                continue
            if fn.name in body_written or _has_time(a):
                continue
            key = (node.func, fn.name, tuple(str(x) for x in a.args))
            if key in seen:
                continue
            seen.add(key)
            total += 4 * int(np.prod(fn.grid.shape))
    return total


def _hoist_shifted_transcendentals(schedule, body_dense, body_written,
                                   existing):
    """Pointwise transcendentals of shifted invariant accesses —
    ``g(f(x+δ))`` with ``g`` ∈ sin/cos/... and ``f`` a time-invariant
    dense function at integer index shifts (TTI's rotated derivatives
    evaluate sin/cos of the tilt fields at every tap position:
    reference examples/seismic/tti/operators.py trig_func) — hoist
    ``t = g(f)`` once into the prologue and rewrite every occurrence as
    the shifted read ``t(x+δ)``: elementwise application commutes with
    index shifts, so the rewrite is exact.  The per-expression cost
    model below cannot catch these (each shifted variant is a distinct,
    individually cheap subexpression; together they put ~19
    transcendentals per point into a 3-D TTI body equation)."""
    from ..types.dense import Function

    occ = {}
    for eq in body_dense:
        eq_ext = max([-a for (a, b) in eq.region] + [0])
        for node in sympy.preorder_traversal(sympy.sympify(eq.rhs)):
            if not isinstance(node, _EXPENSIVE) or len(node.args) != 1:
                continue
            a = node.args[0]
            fn = getattr(a, 'function', None)
            if fn is None or getattr(fn, 'is_SparseFunction', False) \
                    or getattr(fn, 'grid', None) is None:
                continue
            if fn.name in body_written or _has_time(a):
                continue
            dims = tuple(fn.space_dimensions)
            if dims != tuple(fn.grid.dimensions) or \
                    len(a.args) != len(dims):
                continue
            sh = 0
            ok = True
            for d, arg in zip(dims, a.args):
                delta = sympy.sympify(arg) - d
                if not getattr(delta, 'is_number', False):
                    ok = False
                    break
                fdelta = float(delta)
                if not fdelta.is_integer():
                    ok = False
                    break
                sh = max(sh, abs(int(fdelta)))
            if not ok:
                continue
            key = (node.func, fn.name)
            occ.setdefault(key, []).append((node, a, fn, eq_ext + sh))

    mapping = {}
    new_prologue = []
    for (g, fname), hits in occ.items():
        if len(hits) < 2:
            continue
        fn = hits[0][2]
        cap = min(h[0] for h in fn.halo) if fn.halo else 0
        kept = [h for h in hits if h[3] <= cap]
        if len(kept) < 2:
            continue
        E = max(h[3] for h in kept)
        name = f"r{next(_ctr)}"
        while name in existing:
            name = f"r{next(_ctr)}"
        existing.add(name)
        temp = Function(name=name, grid=fn.grid, space_order=E,
                        dtype=fn.dtype)
        type(temp)._hoisted = True
        region = tuple((-E, n + E) for n in fn.grid.shape)
        le = LoweredEq(temp.function, None, None, region, g(fn),
                       time_dep=False)
        le.internal = True
        new_prologue.append(le)
        for node, a, _, _ in kept:
            mapping[node] = temp.function.func(*a.args)

    if not mapping:
        return
    for eq in body_dense:
        eq.rhs = sympy.sympify(eq.rhs).xreplace(mapping)
    schedule.prologue = schedule.prologue + new_prologue


def hoist_invariants(schedule, trig_taps=False):
    """Extract time-invariant, flop-heavy subexpressions of the loop-body
    dense equations into grid temporaries computed once in the prologue.
    Mutates and returns ``schedule``.

    ``trig_taps`` additionally hoists transcendentals of *shifted*
    invariant accesses (opt option 'hoist-trig-taps'): True and False
    force it; the default 'auto' turns it on once
    ``_shifted_trig_blowup_bytes`` passes 1.5e9. That is devito_tpu's rule,
    set for XLA's loop-invariant code motion on a TPU; it is kept so that
    both packages build the same schedule, and chip_smoke.py times both
    settings of the TTI forward on the card."""
    from ..types.dense import Function

    body_dense = [it for it in schedule.body if isinstance(it, LoweredEq)]
    if not body_dense:
        return schedule

    body_written = {eq.target.name for eq in body_dense}

    existing = set()
    for it in schedule.all_items:
        for a in retrieve_functions(getattr(it, 'rhs', 0)):
            existing.add(a.function.name)
        tgt = getattr(it, 'target', None)
        if tgt is not None:
            existing.add(tgt.name)

    if trig_taps == 'auto':
        trig_taps = _shifted_trig_blowup_bytes(body_dense,
                                               body_written) > 1.5e9
    if trig_taps:
        _hoist_shifted_transcendentals(schedule, body_dense, body_written,
                                       existing)

    candidates = {}
    for eq in body_dense:
        _collect(eq.rhs, candidates, body_written)
    if not candidates:
        return schedule

    # hoisted temporaries must cover the widest consumer write region —
    # CIRE temporaries write into the halo (negative region starts)
    ext = 0
    for eq in body_dense:
        for (a, b) in eq.region:
            ext = max(ext, -a)

    mapper = {}
    new_prologue = []
    for cand in candidates:
        accs = _dense_accesses(cand)
        grid = accs[0].function.grid
        if any(a.function.grid is not grid for a in accs):
            continue
        # skip candidates accessing non-canonical dimension layouts
        if any(len(a.function.space_dimensions) != grid.dim for a in accs):
            continue
        name = f"r{next(_ctr)}"
        while name in existing:
            name = f"r{next(_ctr)}"
        existing.add(name)
        temp = Function(name=name, grid=grid, space_order=ext,
                        dtype=grid.dtype)
        type(temp)._hoisted = True
        region = tuple((-ext, n + ext) for n in grid.shape)
        le = LoweredEq(temp.function, None, None, region,
                       cand, time_dep=False)
        le.internal = True   # not a user equation
        new_prologue.append(le)
        mapper[cand] = temp

    if not mapper:
        return schedule

    def _rewrite(expr):
        """Rebuild ``expr`` with hoisted subexpressions (including partial
        Add/Mul groups, which plain xreplace cannot match) replaced by
        their temporaries."""
        expr = sympy.sympify(expr)
        if expr in mapper:
            return mapper[expr]
        if not getattr(expr, 'args', ()):
            return expr
        if isinstance(expr, (sympy.Add, sympy.Mul)):
            inv = [a for a in expr.args if _invariant(a)]
            if inv:
                group = (expr.func(*inv, evaluate=False)
                         if len(inv) > 1 else inv[0])
                if group in mapper:
                    rest = [_rewrite(a) for a in expr.args
                            if not _invariant(a)]
                    return expr.func(mapper[group], *rest)
        if isinstance(expr, AbstractFunction):
            return expr
        return expr.func(*[_rewrite(a) for a in expr.args])

    def _body_reads(rhss):
        names = set()
        for rhs in rhss:
            for a in retrieve_functions(rhs):
                names.add(a.function.name)
        return names

    before_reads = _body_reads([eq.rhs for eq in body_dense])
    rewritten = [_rewrite(eq.rhs) for eq in body_dense]
    after_reads = _body_reads(rewritten)

    # global stream accounting: each live temp is one extra stream per
    # step; each invariant function no longer read is one stream freed.
    # Accept the hoist only if it is stream-neutral or the recomputation
    # savings clearly dominate (one stream ~ 20 weighted ops, devito_tpu's
    # TPU figure, kept so that the schedules match).
    temps_used = {e.target.name for e in new_prologue} & after_reads
    freed = before_reads - after_reads
    added = len(temps_used)
    savings = sum(_weighted_cost(c) for c, t in mapper.items()
                  if t.name in temps_used)
    if added > len(freed) and savings < 20 * (added - len(freed)):
        return schedule

    for eq, rhs in zip(body_dense, rewritten):
        eq.rhs = rhs
    # drop temps shadowed by larger hoisted groups (never read back)
    new_prologue = [e for e in new_prologue if e.target.name in temps_used]

    # invariants must be computed before the loop; they are themselves
    # ordinary prologue equations (reference: Lift hoists whole clusters)
    schedule.prologue = schedule.prologue + new_prologue
    return schedule
