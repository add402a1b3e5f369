"""Interpolation / injection: the lazy symbolic objects and the weight
synthesis used by the executor.

Reference parity: devito/operations/interpolators.py (Interpolation:124,
Injection:157, LinearInterpolator:513, PrecomputedInterpolator:555,
SincInterpolator:590 -- Hicks Kaiser-windowed sinc, b-values from Table 1 of
Hicks 2002). Weight math matches the reference; the lowering is a
vectorized gather/scatter on torch tensors (compiler/executor.py)."""

import numpy as np
import sympy

from ..finite_differences.differentiable import evaluate_expr
from ..ir.lowering import LoweredEq, LoweredSparse, time_access_of
from ..types.basic import AbstractFunction
from ..exceptions import InvalidOperator

__all__ = ['Interpolation', 'Injection', 'LinearInterpolator',
           'SincInterpolator', 'PrecomputedInterpolator',
           'MatrixInterpolator']


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


class SincInterpolator:
    """Hicks (2002) Kaiser-windowed sinc interpolation, radius r in [2, 10]
    (reference: SincInterpolator:590, b-values from its Table 1)."""

    name = 'sinc'

    _b_table = {2: 2.94, 3: 4.53, 4: 4.14, 5: 5.26, 6: 6.40,
                7: 7.51, 8: 8.56, 9: 9.56, 10: 10.64}

    def __init__(self, r=2):
        if r not in self._b_table:
            raise ValueError(f"sinc radius must be in [2, 10], got {r}")
        self.r = r

    @property
    def max_radius(self):
        return self.r

    def dim_weights(self, px):
        """(offsets -r+1..r, the Kaiser-windowed sinc weight of each, base
        indices) of positions ``px`` (grid-point units, a tensor)."""
        import torch
        r, b = self.r, self._b_table[self.r]
        b0 = float(np.i0(b))
        fl = torch.floor(px)
        frac = px - fl
        offsets = list(range(-r + 1, r + 1))
        ws = []
        for off in offsets:
            rpos = off - frac
            arg = torch.clamp(1.0 - (rpos / r) ** 2, min=0.0)
            ws.append(torch.special.i0(b * torch.sqrt(arg)) / b0 *
                      torch.sinc(rpos))
        return offsets, ws, fl.to(torch.int64)

    def ncorners(self, ndim):
        return (2 * self.r) ** ndim


def _table(a, device, dtype=None):
    import torch
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


class MatrixInterpolator:
    """Geometry from explicit gridpoints + per-dim coefficient tables of a
    MatrixSparseTimeFunction (reference: types/sparse.py:1399)."""

    name = 'matrix'

    def __init__(self, sfunction):
        self.sf = sfunction
        self.r = type(sfunction)._r_points

    @property
    def max_radius(self):
        return self.r

    def dim_weights_precomputed(self, j):
        """(offsets 0..r-1, coefficient table (nloc, r), gridpoints (nloc,))
        of axis j, on the function's device."""
        import torch
        dev = type(self.sf)._device
        d = self.sf.grid.dimensions[j]
        gp = _table(self.sf.gridpoints[:, j], dev, torch.int64)
        coeffs = _table(self.sf.interpolation_coefficients[d], dev)
        return list(range(coeffs.shape[1])), coeffs, gp

    def ncorners(self, ndim):
        return self.r ** ndim


class PrecomputedInterpolator:
    """User-supplied gridpoints + per-dim coefficient tables (reference:
    PrecomputedInterpolator:555)."""

    name = 'precomputed'

    def __init__(self, sfunction):
        self.sf = sfunction
        self.r = type(sfunction)._r

    @property
    def max_radius(self):
        return self.r

    def dim_weights_precomputed(self, j):
        """(offsets 0..ncoeffs-1, coefficient table (P, ncoeffs), gridpoints
        (P,)) of axis j, on the function's device; consumed by the
        executor's precomputed geometry."""
        import torch
        dev = type(self.sf)._device
        gp = _table(self.sf.gridpoints[:, j], dev, torch.int64)
        coeffs = _table(self.sf.interpolation_coeffs[:, j, :], dev)
        return list(range(coeffs.shape[-1])), coeffs, gp

    def dim_weights(self, px):
        # positions come from the stored gridpoints: the executor takes
        # ``dim_weights_precomputed`` for this interpolator
        raise NotImplementedError(
            "PrecomputedInterpolator requires the precomputed geometry path")

    def ncorners(self, ndim):
        # devito_tpu's count, kept so that both packages report the same
        # flops: it holds when the coefficient tables are 2r wide
        return (2 * self.r) ** ndim
