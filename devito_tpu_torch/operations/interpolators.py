"""Interpolation / injection: the lazy symbolic objects and the weight
synthesis used by the executor.

Reference parity: devito/operations/interpolators.py (Interpolation:124,
Injection:157, LinearInterpolator:513). Weight math matches the
reference; the lowering is a vectorized gather/scatter on torch tensors
(compiler/executor.py). Sinc, precomputed and matrix interpolation are not
ported yet (ROADMAP.md)."""

import numpy as np
import sympy

from ..finite_differences.differentiable import evaluate_expr
from ..ir.lowering import LoweredEq, LoweredSparse, time_access_of
from ..types.basic import AbstractFunction
from ..exceptions import InvalidOperator

__all__ = ['Interpolation', 'Injection', 'LinearInterpolator']


def _u_t_delta(u_t):
    """Constant time shift encoded by a ``u_t=`` argument (an expression
    in the field's own time index, e.g. ``t + 1`` — reference:
    interpolators.py ``u_t``/``p_t`` shifting)."""
    if u_t is None:
        return 0
    u_t = sympy.sympify(u_t)
    from ..types.dimension import Dimension
    dims = [s for s in u_t.free_symbols if isinstance(s, Dimension)]
    if len(dims) != 1:
        raise InvalidOperator(f"u_t={u_t}: expected <time dim> + const")
    delta = sympy.simplify(u_t - dims[0])
    if not delta.is_number:
        raise InvalidOperator(f"u_t={u_t}: expected <time dim> + const")
    return int(delta)


def _shift_time(expr, u_t):
    """Shift every time-dimension index in ``expr`` by the u_t delta."""
    delta = _u_t_delta(u_t)
    if not delta:
        return expr
    from ..types.dimension import Dimension
    tdims = {s for s in expr.free_symbols
             if isinstance(s, Dimension) and (s.is_Time or (
                 s.is_Derived and s.root.is_Time))}
    return expr.subs({s: s + delta for s in tdims}, simultaneous=True)


class Interpolation:
    """Lazy: ``sparse rows <- interp(expr at point coords)``."""

    def __init__(self, sparse, expr, increment=False, u_t=None,
                 p_t=None, implicit_dims=None):
        self.sparse = sparse.function
        self.expr = expr
        self.increment = increment
        self.u_t = u_t
        self.p_t = p_t
        self.implicit_dims = implicit_dims

    def _lower(self, subs=None):
        # sampled expressions evaluate on the node lattice (the
        # interpolation stencil's anchor points are grid nodes), so
        # derivatives of staggered fields project there — matches the
        # reference's rec.interpolate(expr=div(v)) elastic semantics
        from ..finite_differences.differentiable import interp_for_fd
        x0 = {d: sympy.Rational(0)
              for d in self.sparse.grid.dimensions}
        # bare staggered accesses project onto the node lattice FIRST
        # (pre-evaluation, so Derivative subtrees keep their own exact
        # projection — reference: test_interpolation.py
        # test_interpolate_staggered: the half-cell offset must not be
        # silently dropped)
        expr = interp_for_fd(self.expr, x0)
        expr = evaluate_expr(expr, x0=x0)
        expr = _shift_time(expr, self.u_t)
        if subs:
            expr = expr.subs(subs)
        out = []
        expr = self._densify(expr, out)
        out.append(LoweredSparse('interp', self.sparse, expr,
                                 target_time_off=_u_t_delta(self.p_t),
                                 increment=self.increment))
        return out

    def _densify(self, expr, out):
        """A sampled expression of two or more fields (rec on ``u + v``,
        TTI) over 4096 or more interpolation corners is first computed
        into a dense temporary (``<sparse>_itmp``, a dense equation of the
        step that K1 runs), and the points gather from it once. This is
        devito_tpu's rule, kept so that both packages build the same
        schedule."""
        from ..types.basic import retrieve_functions
        npts = self.sparse.npoint or 0
        accs = [a for a in retrieve_functions(expr)
                if not a.function.is_SparseFunction]
        if len(accs) < 2 or npts * (2 ** max(
                len(self.sparse.grid.dimensions), 1)) < 4096:
            return expr
        grid = self.sparse.grid
        from ..types.dense import Function
        tmp = Function(name=f'{self.sparse.name}_itmp', grid=grid,
                       space_order=self.sparse.interpolator.max_radius,
                       dtype=accs[0].function.dtype)
        type(tmp)._compiler_temp = True
        region = tuple((0, n) for n in grid.shape)
        out.append(LoweredEq(tmp.function, None, None, region, expr,
                             time_dep=True))
        return tmp.function

    def __add__(self, other):
        # reference API: `[eqs...] + sf.interpolate(...)` builds a flat
        # equation list (tests/test_sparse.py:483 and many notebooks);
        # non-iterable operands (another Interpolation/Injection, a bare
        # Eq) coerce to one-element lists, as in the reference where both
        # sides are already plain lists
        return [self] + _as_eqlist(other)

    def __radd__(self, other):
        return _as_eqlist(other) + [self]

    def __repr__(self):
        return f"Interpolation({self.sparse.name} <- {self.expr})"


def _as_eqlist(other):
    return list(other) if hasattr(other, '__iter__') else [other]


class Injection:
    """Lazy: ``field <- field + scatter(weights * expr)``."""

    def __add__(self, other):
        return [self] + _as_eqlist(other)

    def __radd__(self, other):
        return _as_eqlist(other) + [self]

    def __init__(self, sparse, field, expr, u_t=None, implicit_dims=None):
        self.sparse = sparse.function
        self.field = field
        self.expr = expr
        self.u_t = u_t
        self.implicit_dims = implicit_dims

    def _lower(self, subs=None):
        from ..types.tensor import TensorLike
        if isinstance(self.field, (tuple, list)):
            # multi-field injection, e.g. src into (u.forward, v.forward)
            # (reference: tti ForwardOperator, operators.py:460)
            out = []
            for f in self.field:
                out.extend(Injection(self.sparse, f, self.expr,
                                     u_t=self.u_t,
                                     implicit_dims=self.implicit_dims)
                           ._lower(subs=subs))
            return out
        if isinstance(self.field, TensorLike):
            # inject into every distinct nonzero component (reference:
            # src.inject(tau.forward.diagonal(), ...) in elastic)
            out = []
            seen = set()
            for c in self.field.values():
                if c == 0 or id(c) in seen:
                    continue
                seen.add(id(c))
                out.extend(Injection(self.sparse, c, self.expr,
                                     u_t=self.u_t,
                                     implicit_dims=self.implicit_dims)
                           ._lower(subs=subs))
            return out
        expr = evaluate_expr(self.expr)
        if subs:
            expr = expr.subs(subs)
        field = self.field
        if not isinstance(field, AbstractFunction):
            raise InvalidOperator(f"Injection field must be a function "
                                  f"access, got {field}")
        tk, toff = time_access_of(field)
        # halo must cover the interpolation radius
        interp = self.sparse.interpolator
        radius = interp.max_radius
        for (hl, hr) in field.function.halo:
            if hl < radius or hr < radius:
                raise InvalidOperator(
                    f"Injection into {field.function.name}: halo "
                    f"{field.function.halo} smaller than interpolation "
                    f"radius {radius}")
        if tk is not None and toff is not None:
            toff = toff + _u_t_delta(self.u_t)
        expr = _shift_time(expr, self.u_t)
        return [LoweredSparse('inject', self.sparse, expr,
                              field=field.function, field_time_off=toff,
                              field_time_kind=tk)]

    def __repr__(self):
        return f"Injection({self.field} += w*{self.expr})"


class LinearInterpolator:
    """Bi/tri-linear interpolation (reference: LinearInterpolator:513)."""

    name = 'linear'
    max_radius = 1

    def dim_weights(self, px):
        """Given positions ``px`` (grid-point units, a tensor), return
        (offsets, weight tensors, base indices)."""
        import torch
        fl = torch.floor(px)
        frac = px - fl
        return [0, 1], [1.0 - frac, frac], fl.to(torch.int64)

    def ncorners(self, ndim):
        return 2 ** ndim
