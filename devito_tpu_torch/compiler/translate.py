"""Symbolic expression -> torch tensors, and -> one CUDA C++ expression.

This replaces the reference's C code generation (devito/ir/cgen/printer.py
ccode:459). Two printers walk the same evaluated sympy right-hand side:

- ``translate(expr, ctx)`` evaluates it eagerly with torch ops. Its
  contexts are ``DenseCtx`` (function accesses become shifted slices of
  the halo'd row tensors) and ``SparseCtx`` (accesses become gathers at
  the interpolation corner indices).
- ``cuda_expr(expr, ctx)`` prints it as one C++ expression for the
  hand-written stencil kernel (kernels/stencil.py, csrc/stencil.cuh): the
  context turns each access into a load at fixed offsets from its access
  group's row pointer, and each symbol into a kernel parameter.

Both keep sympy's argument order, so sums and products associate the same
way in both.
"""

import math

import numpy as np
import sympy
import torch

from ..types.basic import AbstractFunction
from ..types.dense import widen
from ..types.dimension import Dimension, ConditionalDimension
from ..ir.lowering import (time_access_of, space_offsets_of,
                           space_index_specs)
from ..exceptions import CompilationError

__all__ = ['translate', 'cuda_expr', 'DenseCtx', 'SparseCtx']


def _is_tensor(*xs):
    return any(isinstance(x, torch.Tensor) for x in xs)


def _unary(tfn, sfn):
    """Apply ``tfn`` to a tensor, ``sfn`` to a Python scalar."""
    def f(x):
        return tfn(x) if _is_tensor(x) else sfn(x)
    return f


def _sign(x):
    return float((x > 0) - (x < 0))


_FN_MAP = {
    # NB: sympy.sqrt is a function (not a class) — sqrt exprs are
    # Pow(x, 1/2) and handled in translate
    sympy.sin: _unary(torch.sin, math.sin),
    sympy.cos: _unary(torch.cos, math.cos),
    sympy.tan: _unary(torch.tan, math.tan),
    sympy.exp: _unary(torch.exp, math.exp),
    sympy.log: _unary(torch.log, math.log),
    sympy.sinh: _unary(torch.sinh, math.sinh),
    sympy.cosh: _unary(torch.cosh, math.cosh),
    sympy.tanh: _unary(torch.tanh, math.tanh),
    sympy.asin: _unary(torch.asin, math.asin),
    sympy.acos: _unary(torch.acos, math.acos),
    sympy.atan: _unary(torch.atan, math.atan),
    sympy.Abs: _unary(torch.abs, abs),
    sympy.sign: _unary(torch.sign, _sign),
    sympy.floor: _unary(torch.floor, math.floor),
    sympy.ceiling: _unary(torch.ceil, math.ceil),
    sympy.re: lambda x: x.real if hasattr(x, 'real') else x,
    sympy.im: lambda x: x.imag if hasattr(x, 'imag') else 0.0,
}


def _as_like(x, ref):
    """``x`` as a tensor of ``ref``'s dtype and device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=ref.dtype, device=ref.device)


def _binary(tfn, sfn, a, b):
    if not _is_tensor(a, b):
        return sfn(a, b)
    ref = a if isinstance(a, torch.Tensor) else b
    return tfn(_as_like(a, ref), _as_like(b, ref))


def translate(expr, ctx):
    """Translate a sympy expression into a torch value in context ``ctx``
    (a tensor, or a Python scalar where no access is involved)."""
    expr = sympy.sympify(expr)

    if isinstance(expr, AbstractFunction):
        return ctx.access(expr)
    if isinstance(expr, sympy.Integer):
        return int(expr)
    if isinstance(expr, (sympy.Float, sympy.Rational)):
        return float(expr)
    if expr is sympy.pi:
        return float(np.pi)
    if expr is sympy.I:
        return 1j
    if isinstance(expr, sympy.Number) or (expr.is_number
                                          and expr.is_complex
                                          and not expr.free_symbols):
        c = complex(expr)
        return c if c.imag else c.real
    if isinstance(expr, sympy.Symbol):
        return ctx.symbol(expr)
    if isinstance(expr, sympy.Add):
        out = translate(expr.args[0], ctx)
        for a in expr.args[1:]:
            out = out + translate(a, ctx)
        return out
    if isinstance(expr, sympy.Mul):
        out = translate(expr.args[0], ctx)
        for a in expr.args[1:]:
            out = out * translate(a, ctx)
        return out
    if isinstance(expr, sympy.Pow):
        base = translate(expr.base, ctx)
        e = expr.exp
        if isinstance(e, sympy.Integer):
            n = int(e)
            if n == -1:
                return 1.0 / base
            if 0 <= n <= 4:
                out = 1
                for _ in range(n):
                    out = out * base
                return out
            if -4 <= n < 0:
                out = 1
                for _ in range(-n):
                    out = out * base
                return 1.0 / out
            return base ** n
        if e == sympy.Rational(1, 2):
            return _unary(torch.sqrt, math.sqrt)(base)
        if e == sympy.Rational(-1, 2):
            return _unary(torch.rsqrt, lambda v: 1.0 / math.sqrt(v))(base)
        return base ** translate(e, ctx)
    if isinstance(expr, (sympy.StrictLessThan, sympy.LessThan,
                         sympy.StrictGreaterThan, sympy.GreaterThan,
                         sympy.Equality, sympy.Unequality)):
        l = translate(expr.lhs, ctx)
        r = translate(expr.rhs, ctx)
        # keyed on the sympy base class: types.relational subclasses
        # (Lt/Le/...) must resolve to the same compare
        ops = {sympy.StrictLessThan: lambda a, b: a < b,
               sympy.LessThan: lambda a, b: a <= b,
               sympy.StrictGreaterThan: lambda a, b: a > b,
               sympy.GreaterThan: lambda a, b: a >= b,
               sympy.Equality: lambda a, b: a == b,
               sympy.Unequality: lambda a, b: a != b}
        for base, fn in ops.items():
            if isinstance(expr, base):
                return fn(l, r)
        raise CompilationError(f"Unknown relational {type(expr)}")
    if isinstance(expr, sympy.And):
        out = translate(expr.args[0], ctx)
        for a in expr.args[1:]:
            out = out & translate(a, ctx)
        return out
    if isinstance(expr, sympy.Or):
        out = translate(expr.args[0], ctx)
        for a in expr.args[1:]:
            out = out | translate(a, ctx)
        return out
    if isinstance(expr, sympy.Not):
        v = translate(expr.args[0], ctx)
        return ~v if _is_tensor(v) else (not v)
    if isinstance(expr, sympy.Min):
        out = translate(expr.args[0], ctx)
        for a in expr.args[1:]:
            out = _binary(torch.minimum, min, out, translate(a, ctx))
        return out
    if isinstance(expr, sympy.Max):
        out = translate(expr.args[0], ctx)
        for a in expr.args[1:]:
            out = _binary(torch.maximum, max, out, translate(a, ctx))
        return out
    if isinstance(expr, sympy.Mod):
        a, b = (translate(x, ctx) for x in expr.args)
        return _binary(torch.remainder, lambda x, y: x % y, a, b)
    if isinstance(expr, sympy.Piecewise):
        out = None
        for val, cond in reversed(expr.args):
            v = translate(val, ctx)
            if cond is sympy.true:
                out = v
                continue
            c = translate(cond, ctx)
            other = out if out is not None else 0.0
            out = torch.where(c, v, other) if _is_tensor(c) else \
                (v if c else other)
        return out
    if isinstance(expr, sympy.atan2):
        a, b = (translate(x, ctx) for x in expr.args)
        return _binary(torch.atan2, math.atan2, a, b)

    for sfunc, fn in _FN_MAP.items():
        if isinstance(expr, sfunc):
            return fn(*[translate(a, ctx) for a in expr.args])

    raise CompilationError(f"Cannot translate {type(expr).__name__}: {expr}")


# -- the CUDA C++ printer ------------------------------------------------------

_CUDA_FN = {
    sympy.sin: 'sin', sympy.cos: 'cos', sympy.tan: 'tan', sympy.exp: 'exp',
    sympy.log: 'log', sympy.sinh: 'sinh', sympy.cosh: 'cosh',
    sympy.tanh: 'tanh', sympy.asin: 'asin', sympy.acos: 'acos',
    sympy.atan: 'atan', sympy.Abs: 'fabs', sympy.floor: 'floor',
    sympy.ceiling: 'ceil',
}

_CUDA_REL = ((sympy.StrictLessThan, '<'), (sympy.LessThan, '<='),
             (sympy.StrictGreaterThan, '>'), (sympy.GreaterThan, '>='),
             (sympy.Equality, '=='), (sympy.Unequality, '!='))


def cuda_expr(expr, ctx):
    """Print a real-valued sympy expression as one CUDA C++ expression of
    the kernel's scalar type ``T``. ``ctx.access(e)`` and ``ctx.symbol(s)``
    print accesses and symbols; ``ctx.literal(v)`` prints a number in the
    scalar type (fp32 literals carry the ``f`` suffix, so nothing
    silently promotes to double). Math functions are called by their fp32
    names (``sinf``, ``sqrtf``, ``rsqrtf``, ...) when ``ctx.ctype`` is
    ``'float'``, so an fp32 kernel computes sin, cos and square roots in
    fp32 whatever overloads the headers declare. Raises CompilationError
    on anything else."""
    expr = sympy.sympify(expr)

    def p(e):
        return cuda_expr(e, ctx)

    def fn(name):
        return name + 'f' if ctx.ctype == 'float' else name

    if isinstance(expr, AbstractFunction):
        return ctx.access(expr)
    if isinstance(expr, (sympy.Integer, sympy.Float, sympy.Rational)) or \
            expr is sympy.pi:
        return ctx.literal(float(expr))
    if isinstance(expr, sympy.Symbol):
        return ctx.symbol(expr)
    if isinstance(expr, sympy.Add):
        return '(' + ' + '.join(p(a) for a in expr.args) + ')'
    if isinstance(expr, sympy.Mul):
        return '(' + ' * '.join(p(a) for a in expr.args) + ')'
    if isinstance(expr, sympy.Pow):
        base = p(expr.base)
        e = expr.exp
        one = ctx.literal(1.0)
        if isinstance(e, sympy.Integer):
            # small integer powers become multiplications, as translate
            # does (no pow() call, no promotion)
            n = int(e)
            if n == 0:
                return one
            if -4 <= n <= 4:
                prod = '(' + ' * '.join([base] * abs(n)) + ')'
                return prod if n > 0 else f'({one} / {prod})'
            return f'{fn("pow")}({base}, {ctx.literal(float(n))})'
        if e == sympy.Rational(1, 2):
            return f'{fn("sqrt")}({base})'
        if e == sympy.Rational(-1, 2):
            return f'{fn("rsqrt")}({base})'
        return f'{fn("pow")}({base}, {p(e)})'
    for cls, op in _CUDA_REL:
        if isinstance(expr, cls):
            return f'({p(expr.lhs)} {op} {p(expr.rhs)})'
    if isinstance(expr, sympy.And):
        return '(' + ' && '.join(p(a) for a in expr.args) + ')'
    if isinstance(expr, sympy.Or):
        return '(' + ' || '.join(p(a) for a in expr.args) + ')'
    if isinstance(expr, sympy.Not):
        return f'(!{p(expr.args[0])})'
    if isinstance(expr, (sympy.Min, sympy.Max)):
        name = fn('fmin' if isinstance(expr, sympy.Min) else 'fmax')
        out = p(expr.args[0])
        for a in expr.args[1:]:
            out = f'{name}({out}, {p(a)})'
        return out
    if isinstance(expr, sympy.Piecewise):
        out = None
        for val, cond in reversed(expr.args):
            v = p(val)
            if cond is sympy.true:
                out = v
            else:
                other = out if out is not None else ctx.literal(0.0)
                out = f'({p(cond)} ? {v} : {other})'
        return out
    if isinstance(expr, sympy.atan2):
        return f'{fn("atan2")}({p(expr.args[0])}, {p(expr.args[1])})'
    if isinstance(expr, sympy.sign):
        a = p(expr.args[0])
        zero = ctx.literal(0.0)
        return f'(({a} > {zero}) - ({a} < {zero}))'
    for sfunc, name in _CUDA_FN.items():
        if isinstance(expr, sfunc):
            return f'{fn(name)}({p(expr.args[0])})'
    raise CompilationError(
        f"No CUDA printing for {type(expr).__name__}: {expr}")


# -- torch contexts -----------------------------------------------------------

class BaseCtx:
    def __init__(self, buffers, params, t=None, direction=1):
        self.buffers = buffers
        self.params = params
        self.t = t
        self.direction = direction

    def symbol(self, sym):
        name = sym.name
        if name in self.params:
            return self.params[name]
        if name == '__loop_time__' and self.t is not None:
            # canonical time-axis marker (ir/lowering.py LOOP_TIME)
            return self.t
        if isinstance(sym, Dimension) and self.t is not None:
            root = sym.root if sym.is_Derived else sym
            if root.is_Time:
                # the loop's time index as a value; a time-subsampled
                # ConditionalDimension as a value is t // factor
                if isinstance(sym, ConditionalDimension):
                    f = self._cond_factor_value(sym)
                    if f is not None:
                        return self.t // f
                return self.t
        raise CompilationError(f"Unbound symbol {name}")

    def _cond_factor_value(self, cd):
        """Runtime value of a ConditionalDimension's subsampling factor
        (int, or the runtime param for Constant factors); None if no
        factor."""
        f = getattr(cd, 'factor', None)
        if f is None:
            return None
        nm = getattr(f, 'name', None)
        if nm is not None and nm in self.params:
            return int(self.params[nm])
        try:
            return int(f)
        except TypeError:
            return int(getattr(f, 'data', f))

    def _time_resolved(self, fn, access):
        """The time-resolved row tensor (a view) of an access."""
        from .executor import _resolve_time_indexed
        tk, toff = time_access_of(access)
        return _resolve_time_indexed(self.buffers, fn, tk, toff, self.t,
                                     params=self.params)


class DenseCtx(BaseCtx):
    """Dense region context: accesses -> shifted slices of halo'd rows.

    ``region``: {root dim name: (start, length)} of the write region in
    domain coordinates.
    """

    def __init__(self, buffers, params, region, t=None, direction=1,
                 stride_map=None, device=None):
        super().__init__(buffers, params, t=t, direction=direction)
        self.region = region
        self.device = device
        # {parent dim name: (region dim name, factor)} — the write
        # region iterates a spatially-subsampled ConditionalDimension,
        # so accesses indexed by the PARENT read strided positions
        self.stride_map = stride_map or {}

    def symbol(self, sym):
        if isinstance(sym, Dimension):
            # a bare dimension in an expression -> coordinate index
            # tensor broadcast along its axis over the region
            name = sym.root.name if sym.is_Derived else sym.name
            if sym.is_Time or name not in self.region:
                if sym.is_Time:
                    return self.t
                root = sym.root if sym.is_Derived else sym
                if root.is_Time and self.t is not None:
                    return BaseCtx.symbol(self, sym)
                raise CompilationError(f"Unbound dimension {sym}")
            dims = list(self.region)
            j = dims.index(name)
            start, length = self.region[name]
            shape = [1] * len(dims)
            shape[j] = length
            # on a shard the region is local: ``__shard_off_<dim>__`` (the
            # sharded runner's parameter) keeps the coordinate GLOBAL, so
            # sub-domain masks and x-dependent expressions translate alike
            # on every shard (devito_tpu: translate.py:265-290)
            start = start + self.params.get(f'__shard_off_{name}__', 0)
            return (torch.arange(length, device=self.device) + start
                    ).reshape(shape)
        return super().symbol(sym)

    def access(self, e):
        fn = e.function
        specs = space_index_specs(e)
        arr = self._time_resolved(fn, e)
        halo = fn.halo
        # slice each axis by its INDEXING dimension's region (usually the
        # axis's own dim; another one for transposed indexing A[j, i]);
        # absolute indices become broadcast length-1 lines. Origin
        # offsets translate GLOBAL region coordinates to the local buffer
        # of a SubDomain-defined function (zero for whole-grid).
        origin = fn.origin_offset if hasattr(fn, 'origin_offset') else None
        slices, idx_dims = [], []
        for ax, (sp, (hl, hr)) in enumerate(zip(specs, halo)):
            oo = origin[ax] if origin else 0
            if sp[0] == 'abs':
                s = hl + sp[1] - oo
                slices.append(slice(s, s + 1))
                idx_dims.append(None)
            elif sp[1] not in self.region and sp[1] in self.stride_map:
                # strided access through the parent of a subsampled
                # region dimension: parent index = factor*sub + off
                _, dn, off = sp
                rdn, f = self.stride_map[dn]
                start, length = self.region[rdn]
                s = hl + f * start + off - oo
                slices.append(slice(s, s + f * (length - 1) + 1, f))
                idx_dims.append(rdn)
            else:
                _, dn, off = sp
                start, length = self.region[dn]
                s = hl + start + off - oo
                slices.append(slice(s, s + length))
                idx_dims.append(dn)
        for ax, sl in enumerate(slices):
            # a halo-extended region (CIRE's temporaries, hoisted prologue
            # items) reads past the domain: every tap must stay inside the
            # allocation, where a Python slice would wrap or clip silently
            taps = range(sl.start, sl.stop, sl.step or 1)
            if taps and (taps[0] < 0 or taps[-1] >= arr.shape[ax]):
                raise CompilationError(
                    f"{e} over the region {dict(self.region)} reads outside "
                    f"its allocation {tuple(arr.shape)}")
        # a narrow-stored row widens after the slice: the arithmetic runs
        # in the compute dtype
        arr = widen(arr[tuple(slices)], fn)
        # Align axes to the region's dimension order: free-dimension
        # contractions, transposed indexing and reduced-rank functions
        # need an explicit permute + broadcast.
        rnames = list(self.region)
        if idx_dims != rnames:
            own = [d.name for d in fn.space_dimensions]
            anchored = [dn if dn is not None else
                        (on if on in rnames else None)
                        for dn, on in zip(idx_dims, own)]
            keep = [a for a, dn in enumerate(anchored) if dn is not None]
            if len(keep) < len(anchored):
                arr = arr.reshape(tuple(arr.shape[a] for a in keep))
                anchored = [anchored[a] for a in keep]
            pos = [rnames.index(dn) for dn in anchored]
            order = sorted(range(len(anchored)), key=lambda a: pos[a])
            if order != list(range(len(anchored))):
                arr = arr.permute(tuple(order))
            shape = [1] * len(rnames)
            for t, a in enumerate(order):
                shape[pos[a]] = arr.shape[t]
            arr = arr.reshape(tuple(shape))
        return arr


class SparseCtx(BaseCtx):
    """Sparse point context: dense accesses -> gathers at interpolation
    corner indices; sparse accesses -> point rows.

    ``corner_idx`` {dim name: int64 tensor (C, P)} holds absolute domain
    coordinates, clipped; ``weights`` (C, P) include the out-of-bounds
    mask. ``own``: on a shard, the owned points' indices (the owner bucket,
    devito_tpu: translate.py:486-510): the geometry covers those points
    only, and a sparse row is gathered down to them.
    """

    def __init__(self, buffers, params, corner_idx, weights, sparse_fn,
                 t=None, direction=1, own=None):
        super().__init__(buffers, params, t=t, direction=direction)
        self.corner_idx = corner_idx
        self.weights = weights
        self.sparse_fn = sparse_fn
        self.own = own

    def access(self, e):
        fn = e.function
        if fn.is_SparseFunction:
            row = self._time_resolved(fn, e)  # (P,)
            return row if self.own is None else row[..., self.own]
        arr = self._time_resolved(fn, e)
        offs = space_offsets_of(e)
        idxs = tuple(self.corner_idx[d.name] + (hl + off)
                     for d, off, (hl, hr) in zip(fn.space_dimensions, offs,
                                                 fn.halo))
        return widen(arr[idxs], fn)  # (C, P)
