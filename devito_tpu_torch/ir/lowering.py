"""Expression lowering: user equations -> LoweredEq list + Schedule.

Reference parity: this module plays the role of devito/ir/equations
(lower_exprs — indexification, subdomain shifting) and the clusterizer
(devito/ir/clusters/algorithms.py — toposort, direction detection,
SteppingDimension -> modulo lowering). Equations lower directly to
slice-algebra over halo'd tensors, so the four reference IRs collapse
into one. ``lower_expressions`` runs the CIRE pass (ir/cire.py) first when
asked to.
"""

import numpy as np
import sympy

from ..types.basic import AbstractFunction, retrieve_functions
from ..types.dimension import (Dimension, ConditionalDimension, SubDimension)
from ..types.equation import Eq
from ..types.grid import SubDomain
from ..exceptions import InvalidOperator
from ..utils import as_tuple, filter_ordered

__all__ = ['LoweredEq', 'LoweredSparse', 'Schedule', 'lower_expressions',
           'rebind', 'time_access_of', 'space_offsets_of',
           'space_index_specs', 'estimate_cost']


class LoweredEq:
    """A dense assignment over a rectangular region.

    Attributes:
    - target: canonical function written
    - time_off: integer time offset of the write (None if target timeless)
    - time_kind: 'stepping' | 'save' | 'cond' | None
    - cond_factor: subsampling factor when time_kind == 'cond'
    - region: per-space-dim (start, stop) in domain coordinates
    - rhs: evaluated sympy expression
    - increment: lhs += rhs
    - reduction: None | 'max' | 'min'
    - condition: optional sympy boolean expr (elementwise guard)
    - time_dep: executes inside the time loop
    """

    kind = 'dense'

    def __init__(self, target, time_off, time_kind, region, rhs,
                 increment=False, reduction=None, condition=None,
                 time_dep=False, cond_factor=None, lhs_access=None):
        self.target = target
        self.time_off = time_off
        self.time_kind = time_kind
        self.cond_factor = cond_factor
        self.region = region
        self.rhs = rhs
        self.increment = increment
        self.reduction = reduction
        self.condition = condition
        self.time_dep = time_dep
        self.lhs_access = lhs_access

    def __repr__(self):
        return (f"LoweredEq({self.target.name}[{self.time_kind}"
                f"{self.time_off:+d}] region={self.region} "
                f"inc={self.increment})" if self.time_off is not None else
                f"LoweredEq({self.target.name} region={self.region})")


class LoweredSparse:
    """A lowered sparse operation (gather-interpolate or scatter-inject).

    - kind: 'interp' | 'inject'
    - sparse: the sparse function (points carrier)
    - expr: evaluated expression (contains dense/sparse accesses)
    - field: (inject) dense function written; time_off its write offset
    - target_time_off: (interp) time offset of the sparse row written
    - interpolator: the sparse function's interpolator (weights machinery)
    - increment: interp accumulates instead of overwriting
    """

    def __init__(self, kind, sparse, expr, field=None, field_time_off=None,
                 field_time_kind=None, target_time_off=0, increment=False,
                 implicit_dims=None, time_dep=None):
        self.kind = kind
        self.sparse = sparse
        self.expr = expr
        self.field = field
        self.field_time_off = field_time_off
        self.field_time_kind = field_time_kind
        self.target_time_off = target_time_off
        self.increment = increment
        if time_dep is None:
            time_dep = (field_time_kind is not None
                        or sparse.is_SparseTimeFunction or _has_time(expr))
        self.time_dep = time_dep

    def __repr__(self):
        return f"LoweredSparse({self.kind}, {self.sparse.name})"


class Schedule:
    """Execution schedule: prologue (once, before), body (time loop),
    epilogue (once, after), and the loop direction (+1 forward / -1
    backward). Reference analog: the cluster toposort + direction
    detection (ir/clusters/algorithms.py:29)."""

    def __init__(self, prologue, body, epilogue, direction):
        self.prologue = prologue
        self.body = body
        self.epilogue = epilogue
        self.direction = direction

    @property
    def all_items(self):
        return self.prologue + self.body + self.epilogue


def rebind(schedule, functions):
    """A copy of ``schedule`` whose items access, in place of each function
    named in ``functions`` ({name: function}), that function: every access
    in a right-hand side, a condition, a sampled expression, and each
    target and injected field. The items are shallow copies, so their
    regions, time accesses and flags stay; an Operator runs a bound
    function of another halo on it (``Operator._relaid``). Names, not
    classes, identify a function: an unpickled schedule's accesses of one
    function may each have a class of their own."""
    import copy

    def new(a):
        return type(functions[a.name])(*a.args)

    def sub(e):
        if not isinstance(e, sympy.Basic):
            return e
        if isinstance(e, AbstractFunction):
            return new(e) if e.name in functions else e
        hits = {a: new(a) for a in e.atoms(AbstractFunction)
                if a.name in functions}
        return e.xreplace(hits) if hits else e

    def item(it):
        out = copy.copy(it)
        for k in ('target', 'rhs', 'condition', 'lhs_access', 'expr',
                  'field'):
            if getattr(out, k, None) is not None:
                setattr(out, k, sub(getattr(out, k)))
        for k in ('target', 'field'):
            if getattr(out, k, None) is not None:
                setattr(out, k, getattr(out, k).function)
        return out

    return Schedule([item(i) for i in schedule.prologue],
                    [item(i) for i in schedule.body],
                    [item(i) for i in schedule.epilogue], schedule.direction)


LOOP_TIME = sympy.Symbol('__loop_time__')


def has_time_lead(fn, dims=None):
    """True when the function's leading axis is a time axis — a
    Time/Stepping/Conditional dimension, or ANY dimension a TimeFunction
    was given as its time_dim (reference accepts plain Dimensions)."""
    dims = dims if dims is not None else fn.dimensions
    if not dims:
        return False
    return (dims[0].is_Time or isinstance(dims[0], ConditionalDimension)
            or (getattr(fn, 'is_TimeFunction', False)
                and fn.time_dim is dims[0]))


def time_access_of(access):
    """For a function access, return (time_kind, offset_expr) — how its
    (possibly absent) time index relates to the loop variable."""
    fn = access.function
    dims = fn.dimensions
    if not dims:
        return (None, None)
    if not has_time_lead(fn, dims):
        return (None, None)
    d0 = dims[0]
    arg0 = access.args[0]

    def _off(a):
        off = sympy.simplify(a - d0)
        if not off.is_number:
            # the user may index with the grid's TimeDimension where the
            # function carries a SteppingDimension (low-level BC idiom
            # Eq(u[t+1, 0, y], ...)); the root time symbol is
            # interchangeable with its derived stepping symbol
            root = getattr(d0, 'parent', None) or getattr(d0, 'root', None)
            if root is not None:
                off = sympy.simplify(a.subs(root, d0) - d0)
        return int(off)

    a0 = sympy.sympify(arg0)
    if not any(isinstance(s, Dimension) for s in a0.free_symbols):
        # absolute time index — an integer or runtime Constant (the
        # reference's `f[tc, x, y]` probing idiom, tests/test_constant.py):
        # resolved against the save axis at run time
        return ('abs', a0)
    if isinstance(d0, ConditionalDimension):
        return ('cond', _off(arg0))
    if d0.is_Stepping:
        return ('stepping', _off(arg0))
    # is_Time, or a plain dimension serving as a TimeFunction's time
    # axis: full-history (save) indexing
    return ('save', _off(arg0))


def space_index_specs(access):
    """Classify each spatial index expression of an access. Returns, per
    space axis, one of:
    - ('rel', dim_name, k): affine in some region dimension (usually the
      axis's own; a different one for transposed indexing like A[j, i],
      the reference misc/linalg.py transpose_mat_vec);
    - ('abs', c): a constant index (low-level u[t+1, 0, y] API).
    """
    fn = access.function
    dims = fn.dimensions
    args = access.args
    start = 1 if has_time_lead(fn, dims) else 0
    specs = []
    for d, a in zip(dims[start:], args[start:]):
        a = sympy.sympify(a)
        free = [s for s in a.free_symbols if isinstance(s, Dimension)]
        if not free:
            if a.is_number and a.is_integer is not False:
                specs.append(('abs', int(a)))
                continue
            raise InvalidOperator(f"Non-affine access {access}")
        if len(free) > 1:
            raise InvalidOperator(f"Multi-dimension index in {access}")
        dd = free[0]
        off = sympy.simplify(a - dd)
        if not (off.is_number and off.is_integer is not False):
            raise InvalidOperator(f"Non-affine access {access}")
        root = dd.root if dd.is_Derived else dd
        specs.append(('rel', root.name, int(off)))
    return tuple(specs)


def space_offsets_of(access, absolute='raise'):
    """Integer spatial offsets of an access, aligned with the function's
    space dimensions.

    ``absolute`` controls how constant (dimension-free) indices — the
    low-level ``u[t+1, 0, y]`` API — are treated:
    - 'raise' (default): InvalidOperator, the stencil-access contract;
    - 'keep': return ``('abs', c)`` entries alongside plain int offsets;
    - 'zero': treat as offset 0 (conservative, for halo/dependence sizing
      where an absolute index needs no halo).
    """
    fn = access.function
    dims = fn.dimensions
    args = access.args
    start = 1 if has_time_lead(fn, dims) else 0
    offs = []
    for d, a in zip(dims[start:], args[start:]):
        off = sympy.simplify(a - d)
        if not (off.is_number and off.is_integer is not False):
            a_s = sympy.simplify(a)
            if a_s.is_number and a_s.is_integer is not False:
                # constant index: absolute position, not a stencil offset
                if absolute == 'keep':
                    offs.append(('abs', int(a_s)))
                    continue
            if absolute == 'zero':
                # conservative: absolute/cross-dimension indices need no
                # halo and carry no stencil offset
                offs.append(0)
                continue
            raise InvalidOperator(f"Non-affine access {access}")
        else:
            offs.append(int(off))
    return tuple(offs)


def _has_time(expr):
    for f in retrieve_functions(expr):
        dims = f.function.dimensions
        if has_time_lead(f.function, dims):
            if time_access_of(f)[0] == 'abs':
                # absolute (constant/runtime-symbol) time index: the
                # access is loop-invariant, not time-dependent
                continue
            return True
    free = getattr(expr, 'free_symbols', set())
    return any(isinstance(s, Dimension) and s.is_Time for s in free)


def _subdim_bounds(sd, n):
    """(start, stop) of a SubDimension within a domain of size ``n``
    (reference: SubDimension left/right/middle thickness semantics)."""
    side = sd.side
    w = getattr(sd, '_width', None)
    if side == 'left':
        return (0, int(w))
    if side == 'right':
        return (n - int(w), n)
    lt, rt = sd.thickness
    return (int(lt or 0), n - int(rt or 0))


def _restrict_subdims(lhs, region):
    """Intersect the write region with any SubDimension used as an index
    in the lhs access (the reference's `eq.subs(x, xi)` idiom for
    boundary-strip equations)."""
    if region is None:
        return region
    fn = lhs.function
    dims = fn.dimensions
    args = lhs.args
    start = 1 if has_time_lead(fn, dims) else 0
    own = set(fn.space_dimensions)
    out = list(region)
    for axis, a in enumerate(args[start:]):
        free = [d for d in sympy.sympify(a).free_symbols
                if isinstance(d, Dimension) and getattr(d, 'is_Sub', False)]
        if not free:
            continue
        sd = free[0]
        if sd in own:
            # a SubDomain-defined function's own SubDimension: the write
            # region from _region_of already covers exactly its bounds
            continue
        a0, b0 = out[axis]
        sa, sb = _subdim_bounds(sd, b0 if b0 is not None else 0)
        out[axis] = (max(a0, sa), min(b0, sb))
    return tuple(out)


def _region_of(target, subdomain):
    """(start, stop) per space dim of the write region, in GLOBAL domain
    coordinates (a target defined on a SubDomain iterates its own region;
    the compiler subtracts its origin_offset when addressing the local
    buffer)."""
    fn = target.function
    sshape = fn.shape if not fn.is_TimeFunction else fn.shape[1:]
    if fn.is_SparseFunction:
        return None
    own = getattr(fn, 'subdomain', None)
    if subdomain is None:
        if own is not None:
            return own.bounds()
        return tuple((0, n) for n in sshape)
    if isinstance(subdomain, SubDomain):
        bounds = subdomain.bounds()
        if own is not None:
            # intersect the eq's subdomain with the function's own region
            bounds = tuple((max(a0, b0), min(a1, b1))
                           for (a0, a1), (b0, b1)
                           in zip(own.bounds(), bounds))
        return bounds
    raise InvalidOperator(f"Bad subdomain {subdomain}")


def lower_one(eq):
    """Lower a single (already evaluated) Eq to LoweredEq (or a list, for
    SubDomainSet equations — one rectangular region each, the static
    analog of the reference's implicit-equation lowering,
    passes/clusters/implicit.py:19)."""
    from ..types.grid import SubDomainSet
    if isinstance(eq.subdomain, SubDomainSet):
        sdset = eq.subdomain
        grid = getattr(sdset, '_grid', None) or eq.lhs.function.grid
        out = []
        for region in sdset.region_bounds(grid):
            # the clone must keep implicit_dims/coefficients — dropping
            # them silently discarded ConditionalDimension guards on
            # SubDomainSet equations (reference: test_subdomains.py
            # test_guarding:675)
            sub = lower_one(type(eq)(eq.lhs, eq.rhs,
                                     coefficients=eq._coefficients,
                                     implicit_dims=eq.implicit_dims,
                                     evaluate=False))
            if isinstance(sub, list):
                raise InvalidOperator(
                    "Self-referential spatial recurrences on a "
                    "SubDomainSet are not supported")
            sub.region = region
            out.append(sub)
        return out
    lhs, rhs = eq.lhs, eq.rhs
    if not isinstance(lhs, AbstractFunction):
        raise InvalidOperator(f"Unsupported lhs {lhs} (not a function access)")
    fn = lhs.function
    if fn.is_SparseFunction:
        # direct write to a sparse function row, e.g. Eq(rec, expr) via
        # interpolation API; handled by LoweredSparse in the operator
        raise InvalidOperator(
            "Direct sparse assignments must go through .interpolate()")

    tk, toff = time_access_of(lhs)
    specs = space_index_specs(lhs)
    own = [d.root.name if d.is_Derived else d.name
           for d in fn.space_dimensions]
    for sp, dn in zip(specs, own):
        if sp[0] == 'rel' and (sp[1] != dn or sp[2] != 0):
            raise InvalidOperator(
                f"Shifted spatial writes not supported (lhs {lhs})")

    region = _region_of(lhs, eq.subdomain)
    if eq.subdomain is None and region is not None:
        # reads of SubDomain-defined functions bound the iteration to
        # their region (reference: test_subdomains.py
        # test_unspecified_subdomain — Eq(g, f) with f on a SubDomain
        # iterates f's region)
        for a in retrieve_functions(rhs):
            f2 = a.function
            own2 = getattr(f2, 'subdomain', None)
            if own2 is None or f2.is_SparseFunction:
                continue
            b2 = own2.bounds()
            if len(b2) != len(region):
                continue  # reduced-rank operand: no axis alignment
            region = tuple((max(a0, b0), min(a1, b1))
                           for (a0, a1), (b0, b1) in zip(region, b2))
    region = _restrict_subdims(lhs, region)
    hw = int(getattr(eq, '_halo_write', 0) or 0)
    if hw and eq.subdomain is None:
        # CIRE temporary: computed into the halo so consumer stencils'
        # taps stay valid (reference: restricted-ispace aliases,
        # passes/clusters/aliases.py lower_aliases:681)
        region = tuple((a - hw, b + hw) for a, b in region)
    if any(sp[0] == 'abs' for sp in specs):
        # low-level indexed write (Eq(u[t+1, 0, y], ...)): a constant
        # index pins that dimension's region to the single point
        region = tuple((sp[1], sp[1] + 1) if sp[0] == 'abs' else r
                       for sp, r in zip(specs, region))
    cond = None
    cond_factor = None
    if tk == 'cond':
        cd = fn.dimensions[0]
        cond_factor = cd.factor
        cond = cd.condition
    # equations over ConditionalDimensions: via implicit_dims, or by a
    # bare ConditionalDimension SYMBOL appearing in the rhs/condition
    # (reference: test_dimension.py test_no_index:1225 — using the dim
    # in an expression pulls in its guard)
    implicit = list(as_tuple(eq.implicit_dims))
    for s in sympy.sympify(rhs).free_symbols:
        if isinstance(s, ConditionalDimension) and s not in implicit:
            implicit.append(s)
    for d in implicit:
        if not isinstance(d, ConditionalDimension):
            continue
        if d.condition is not None:
            cond = d.condition if cond is None else sympy.And(
                cond, d.condition)
        if d.factor is not None and tk != 'cond':
            # a factor-type dim guards on parent % factor == 0
            # (reference: test_implict_dims_multiple:1418); symbolic
            # (Constant) factors resolve at run time
            fguard = sympy.Eq(sympy.Mod(d.parent, d.factor), 0,
                              evaluate=False)
            cond = fguard if cond is None else sympy.And(cond, fguard)
    if cond is not None:
        # a PLAIN dimension serving as the time axis (reference idiom:
        # TimeFunction(dimensions=[Dimension('time')])) is not is_Time,
        # so the translator cannot recognise it — canonicalize every
        # time-axis symbol in the condition to LOOP_TIME
        tsyms = set()
        td = getattr(fn, 'time_dim', None)
        if td is not None:
            tsyms.add(td)
            r = getattr(td, 'parent', None) or getattr(td, 'root', None)
            if r is not None:
                tsyms.add(r)
        sub = {s: LOOP_TIME for s in cond.free_symbols
               if isinstance(s, Dimension)
               and (s.is_Time or (s in tsyms and not s.is_Space))}
        if sub:
            cond = cond.subs(sub)

    time_dep = tk is not None or _has_time(rhs) or cond_factor is not None
    out = LoweredEq(fn, toff, tk, region, rhs,
                    increment=eq.is_Increment and eq._reduction is None,
                    reduction=eq._reduction,
                    condition=cond, time_dep=time_dep,
                    cond_factor=cond_factor, lhs_access=lhs)
    return _split_spatial_recurrence(out)


def _split_spatial_recurrence(leq):
    """Lower a self-referential spatial recurrence to per-line equations.

    An eq whose rhs reads ITS OWN write row at a nonzero spatial offset
    (the BC-extrapolation idiom ``Eq(u[t+1, xleft, yi],
    u[t+1, xleft+1, yi] + 1)``) is a sequential chain along that axis —
    the reference's dependence analysis marks the loop SEQUENTIAL with a
    direction (ir/support/basic.py Scope); a vectorized slice assignment
    would silently compute the Jacobi variant. Split the (small, strip-
    sized) extent into one equation per line, ordered so each line reads
    the previous line's fresh value (reference: tests/test_dimension.py
    test_bcs:363)."""
    fn = leq.target
    axes = {}
    for a in retrieve_functions(leq.rhs):
        if a.function.name != fn.name:
            continue
        tkk, toff2 = time_access_of(a)
        if tkk != leq.time_kind:
            continue
        if leq.time_kind is not None:
            # EXACT time-offset equality: a modulo-aliased row (e.g.
            # u.backward sharing u.forward's physical slot at m=2) holds
            # the OLD time level — monolithic read-then-overwrite is the
            # correct Jacobi semantics there, not a recurrence
            try:
                if int(toff2) != int(leq.time_off):
                    continue
            except (TypeError, ValueError):
                continue
        # offsets via index specs: a subdim-indexed read (u[t+1,
        # xleft+1, yi]) carries its offset relative to the SubDimension
        specs = space_index_specs(a)
        for j, sp in enumerate(specs):
            if sp[0] == 'rel' and sp[2] != 0:
                axes.setdefault(j, set()).add(sp[2])
    if not axes:
        return leq
    if len(axes) > 1:
        raise InvalidOperator(
            f"Self-referential write-row reads along multiple axes in "
            f"{leq}: no sequential order exists")
    (j, offsets), = axes.items()
    if min(offsets) < 0 < max(offsets):
        raise InvalidOperator(
            f"Self-referential write-row reads with mixed-sign offsets "
            f"in {leq}: no sequential order exists")
    lo, hi = leq.region[j]
    if hi - lo > 64:
        raise InvalidOperator(
            f"Self-referential spatial recurrence over {hi - lo} lines "
            f"in {leq}: only strip-sized (<= 64) extents are unrolled")
    lines = range(lo, hi) if max(offsets) < 0 else \
        reversed(range(lo, hi))
    out = []
    for i in lines:
        sub = LoweredEq(leq.target, leq.time_off, leq.time_kind,
                        tuple((i, i + 1) if k == j else r
                              for k, r in enumerate(leq.region)),
                        leq.rhs, increment=leq.increment,
                        reduction=leq.reduction, condition=leq.condition,
                        time_dep=leq.time_dep,
                        cond_factor=leq.cond_factor,
                        lhs_access=leq.lhs_access)
        out.append(sub)
    return out


def _normalize_subs(subs):
    """Re-sympify numeric substitution values at full (53-bit) precision.

    ``grid.spacing_map`` carries grid-dtype scalars (np.float32 by
    default, reference parity); sympy tags those Float(prec=24), and a
    single 24-bit operand downgrades every constant fold it touches —
    FD weights like 4/3 were reaching the trace as float32-rounded
    values even for fp64/complex128 functions. Values are preserved
    exactly (float32 -> float64 is exact); only the working precision
    of the symbolic fold is restored to double."""
    if not subs:
        return subs
    out = {}
    for k, v in subs.items():
        if isinstance(v, (np.floating, float)):
            out[k] = sympy.Float(float(v), precision=53)
        elif isinstance(v, (np.complexfloating, complex)):
            c = complex(v)
            out[k] = (sympy.Float(c.real, precision=53)
                      + sympy.I * sympy.Float(c.imag, precision=53))
        else:
            out[k] = v
    return out


def lower_expressions(expressions, subs=None, cire=None):
    """Evaluate + lower a list of user expressions into a Schedule.

    ``cire``: None = follow configuration['cire']; False disables the
    extraction pass (opt='noop' mode)."""
    from ..operations.interpolators import Interpolation, Injection
    from ..parameters import configuration

    subs = _normalize_subs(subs)

    flat = list(_flatten_exprs(expressions))
    if cire is None:
        cire = configuration['cire']
    if cire:
        # CIRE analog: materialize nested / cross-equation-shared
        # derivative subexpressions into temporaries (ir/cire.py)
        from .cire import extract_derivative_temps
        temps, flat = extract_derivative_temps(flat)
        flat = list(temps) + list(flat)

    items = []
    for e in flat:
        if isinstance(e, (Interpolation, Injection)):
            items.extend(e._lower(subs=subs))
        elif isinstance(e, Eq):
            ev = e.evaluate
            hw = getattr(e, '_halo_write', 0)
            if hw:
                ev._halo_write = hw
            if subs:
                ev = ev.subs(subs)
                if hw:
                    ev._halo_write = hw
            lowered = lower_one(ev)
            if isinstance(lowered, list):
                items.extend(lowered)
            else:
                items.append(lowered)
        else:
            raise InvalidOperator(f"Cannot lower {type(e).__name__}: {e}")

    # Transitive time dependence: an equation reading a function written
    # per-step is itself per-step even when its DIRECT reads carry no
    # time index -- cire2 = f(cire0) where cire0 = f(u[t]) reads only
    # timeless temps, so it would otherwise land in the prologue and run
    # once. Accesses of TimeFunctions always carry a time index, so only
    # reads of body-written TIMELESS temporaries are affected.
    def _witem(it):
        if isinstance(it, LoweredEq):
            return {it.target.name}
        if isinstance(it, LoweredSparse):
            return ({it.field.name} if it.kind == 'inject'
                    else {it.sparse.name})
        return set()

    def _ritem(it):
        out = set()
        if isinstance(it, LoweredEq):
            exprs = [it.rhs] + ([it.condition]
                                if it.condition is not None else [])
        else:
            exprs = [it.expr]
        for e in exprs:
            for a in retrieve_functions(e):
                out.add(a.function.name)
        if isinstance(it, LoweredSparse):
            out.add(it.sparse.name)
        return out

    changed = True
    while changed:
        changed = False
        tdep_writes = set()
        for it in items:
            if it.time_dep:
                tdep_writes |= _witem(it)
        for it in items:
            if not it.time_dep and (_ritem(it) & tdep_writes):
                it.time_dep = True
                changed = True

    # Split prologue / loop body / epilogue
    body = [i for i in items if i.time_dep]
    if body:
        first = items.index(body[0])
        last = max(i for i, it in enumerate(items) if it.time_dep)
        prologue = [it for it in items[:first] if not it.time_dep]
        epilogue = [it for it in items[last + 1:] if not it.time_dep]
        middle_static = [it for it in items[first:last + 1] if not it.time_dep]
        # statics interleaved with time-deps: keep them in the loop (rare;
        # matches reference cluster fusion semantics closely enough)
        merged_body = [it for it in items[first:last + 1]]
        body = merged_body
    else:
        prologue, epilogue = items, []
        body = []

    # Direction: from write offsets in the body
    direction = 1
    has_fwd = any(getattr(i, 'time_off', 0) not in (None,) and i.time_off > 0
                  for i in body if isinstance(i, LoweredEq))
    has_bwd = any(getattr(i, 'time_off', 0) not in (None,) and i.time_off < 0
                  for i in body if isinstance(i, LoweredEq))
    has_fwd = has_fwd or any(isinstance(i, LoweredSparse) and
                             (i.field_time_off or 0) > 0 for i in body)
    has_bwd = has_bwd or any(isinstance(i, LoweredSparse) and
                             (i.field_time_off or 0) < 0 for i in body)
    if has_bwd and not has_fwd:
        direction = -1

    sched = Schedule(prologue, body, epilogue, direction)
    from .support import validate_directions
    validate_directions(sched)
    return sched


def _flatten_exprs(expressions):
    from ..types.equation import TensorEq
    out = []
    for e in as_tuple(expressions):
        if isinstance(e, (list, tuple)):
            out.extend(_flatten_exprs(e))
        elif isinstance(e, TensorEq):
            # flatten tensor/vector equations to per-component equations
            # (reference: operator.py _lower_exprs flattening)
            out.extend(e.flatten())
        else:
            out.append(e)
    return out


_TRANSCENDENTAL = (sympy.sin, sympy.cos, sympy.tan, sympy.exp, sympy.log,
                   sympy.sinh, sympy.cosh, sympy.tanh, sympy.asin,
                   sympy.acos, sympy.atan)


def estimate_cost(expr):
    """Flop count of an expression (reference:
    devito/symbolics/inspection.py estimate_cost:67 — feeds the GFlops/s
    reporting). Integer powers expand to repeated multiplies (the
    translator's lowering, compiler/translate.py Pow), divisions and
    fractional powers count their polynomial-approximation cost on the
    VPU, and transcendentals a measured ~10 ops."""
    flops = 0

    def _walk(e):
        nonlocal flops
        if not isinstance(e, sympy.Basic) or not e.args:
            return
        if isinstance(e, sympy.Add) or isinstance(e, sympy.Mul):
            flops += len(e.args) - 1
        elif isinstance(e, sympy.Pow):
            ex = e.exp
            if getattr(ex, 'is_Integer', False):
                n = abs(int(ex))
                flops += max(n - 1, 0) + (4 if int(ex) < 0 else 0)
            else:
                flops += 8  # sqrt/rsqrt/generic pow
        elif isinstance(e, _TRANSCENDENTAL) or isinstance(e, sympy.Function) \
                and not isinstance(e, AbstractFunction):
            flops += 10
        if isinstance(e, AbstractFunction):
            return
        for a in e.args:
            _walk(a)

    _walk(sympy.sympify(expr))
    return flops
