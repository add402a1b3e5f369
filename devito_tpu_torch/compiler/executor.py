"""Executor: the time loop of an Operator, over rolling buffers.

Replaces the reference's generated C time loop (devito/operator/
operator.py apply:956). ``build_runner`` turns a Schedule into
``run(bufs, params, time_m, time_M)``: a Python loop over time steps that
executes the prologue once, then the body per step, then the epilogue.

Rolling time buffers (SteppingDimension semantics) are the functions'
own (nslots, ...) tensors; ``u[t + k]`` is row ``(t + k) % nslots``
(``step_row``). Every write updates its row IN PLACE:

- a dense equation the stencil kernel accepts (kernels/stencil.py
  ``plan_for``, decided once per equation when the runner is built) goes
  to ``stencil_update``, which launches the CUDA kernel on CUDA tensors
  and runs its plain PyTorch version on CPU tensors;
- any other dense equation is evaluated by the torch translator
  (compiler/translate.py) into a fresh tensor, then copied into the
  target row;
- injection scatter-adds into its row, interpolation writes one row of
  the sparse function: by a gather of each point's corners, or, when
  ``Operator._prepare`` factorised the coordinates into a tensor product
  (``<name>_sep`` in ``bufs``, operations/separable.py), by per-axis
  contractions of the band of the field its weights touch.

A ``save`` access resolves to row ``t + toff - __save_base_<name>__``
(``save_row``): under host streaming the function's tensor is a window of
rows whose first holds that time; the base is 0 otherwise.

A function may be stored narrower than it computes (``storage-dtype``,
``types/dense.py`` ``set_storage_dtype``): every read widens its slice to
the compute dtype, the arithmetic runs there, and the write rounds to the
storage dtype.

With ``errctl`` (written stepping functions by name) the loop runs the
reference's stability scan: after each step t with t mod 100 == 0 the sum
of slot 0 of each is tested for finiteness (one host read); after the
first bad check the remaining steps are skipped and ``run`` returns that
step.
"""

from collections import OrderedDict
from itertools import product

import torch
from torch.profiler import record_function

from ..ir.lowering import LoweredEq, LoweredSparse
from ..exceptions import CompilationError
from ..kernels.stencil import plan_for, stencil_update
from ..types.dense import widen

__all__ = ['build_runner', 'step_row', 'save_row', 'plan_rows']


def step_row(t, toff, m):
    """Buffer row of a stepping access ``u[t + toff]`` (row r holds time
    tau with tau % m == r)."""
    return (t + toff) % m


def factor_value(f, params=None):
    """Runtime value of a ConditionalDimension subsampling factor: an
    int, or the runtime value of a Constant-valued factor."""
    if f is None:
        return 1
    nm = getattr(f, 'name', None)
    if nm is not None and params is not None and nm in params:
        return int(params[nm])
    try:
        return int(f)
    except TypeError:
        return int(getattr(f, 'data', f))


def _eval_scalar(e, params):
    """Evaluate a scalar sympy expression of runtime parameters (used for
    absolute time indices)."""
    import sympy
    e = sympy.sympify(e)
    if e.is_Number:
        return int(e) if e.is_Integer else float(e)
    if isinstance(e, sympy.Symbol):
        if e.name not in params:
            raise CompilationError(f"Unknown runtime symbol {e.name}")
        return params[e.name]
    if e.is_Add:
        return sum(_eval_scalar(a, params) for a in e.args)
    if e.is_Mul:
        out = 1
        for a in e.args:
            out = out * _eval_scalar(a, params)
        return out
    if e.is_Pow:
        return _eval_scalar(e.base, params) ** _eval_scalar(e.exp, params)
    raise CompilationError(f"Cannot evaluate runtime index {e}")


def _time_row_index(fn, tk, toff, t, params):
    """Buffer row of a time-resolved access (None when the function has
    no time axis)."""
    if tk is None:
        return None
    if tk == 'stepping':
        if t is None:
            raise CompilationError("Stepping access outside the time loop")
        return step_row(t, toff, fn._time_size)
    if tk == 'save':
        return save_row(t, toff, params, fn)
    if tk == 'cond':
        return t // factor_value(fn.dimensions[0].factor, params) + toff
    if tk == 'abs':
        return int(_eval_scalar(toff, dict(params or {},
                                           __loop_time__=t)))
    raise CompilationError(f"Bad time access kind {tk}")


def save_row(t, toff, params, fn):
    """Buffer row of a ``save`` access at time ``t + toff``. Under host
    streaming (Operator._apply_streamed) the streamed function's tensor
    holds only a window of rows and ``__save_base_<name>__`` (riding the
    params) is the time of its row 0; for any other function the base is
    0 (reference: devito_tpu/compiler/executor.py save_row)."""
    base = 0
    if params is not None:
        base = params.get(f'__save_base_{fn.name}__', 0)
    return t + toff - base


def _resolve_time_indexed(bufs, fn, tk, toff, t, params=None):
    """The row tensor (a view) of a time-resolved access."""
    buf = bufs[fn.name]
    row = _time_row_index(fn, tk, toff, t, params)
    return buf if row is None else buf[row]


def _target_row(eq, bufs, t, params):
    """The row tensor (a view) ``eq`` writes."""
    tk = eq.time_kind
    if tk == 'cond':
        row = t // factor_value(eq.cond_factor, params) + eq.time_off
        return bufs[eq.target.name][row]
    return _resolve_time_indexed(bufs, eq.target, tk, eq.time_off, t,
                                 params)


def _write_due(eq, bufs, t, params):
    """False on the steps a subsampled (ConditionalDimension) write
    skips: those off its factor, those whose row lies past the saved rows
    (a write under a condition may run past them; the reference drops
    it), and those where a condition that reads time alone is false. All
    are decided before the target row is indexed."""
    if eq.time_kind != 'cond':
        return True
    factor = factor_value(eq.cond_factor, params)
    if t % factor or not \
            0 <= t // factor + eq.time_off < bufs[eq.target.name].shape[0]:
        return False
    if _time_only(eq.condition):
        from .translate import translate, BaseCtx
        return bool(translate(eq.condition, BaseCtx({}, params, t=t)))
    return True


def _time_only(cond):
    """True when the condition ``cond`` (or None) reads neither a field
    nor a space dimension, so one value holds for the whole step."""
    from ..types.basic import AbstractFunction
    return cond is not None and not cond.atoms(AbstractFunction) and not \
        any(getattr(s, 'is_Space', False) for s in cond.free_symbols)


def _write_region_slices(eq):
    """Row slices of the write region of a dense eq. Regions are GLOBAL
    domain coordinates; a target defined on a SubDomain subtracts its
    origin offset to address the local buffer. A halo-extended region
    (CIRE's temporaries, the hoisted prologue items) starts before the
    domain and stops past it, inside the target's halo."""
    fn = eq.target
    return tuple(slice(hl + start - oo, hl + stop - oo)
                 for (start, stop), (hl, hr), oo
                 in zip(eq.region, fn.halo, fn.origin_offset))


def _region_map(eq):
    """{dim name: (start, length)} for the translator — SubDimension
    axes key by their ROOT names."""
    fn = eq.target
    return OrderedDict(
        ((d.root.name if getattr(d, 'is_Sub', False) else d.name),
         (start, stop - start))
        for d, (start, stop) in zip(fn.space_dimensions, eq.region))


def _stride_map(eq):
    """{parent dim name: (target dim name, factor)} for target space
    dims that are spatially-subsampled ConditionalDimensions."""
    out = {}
    for d in eq.target.space_dimensions:
        if getattr(d, 'is_Conditional', False) and d.parent is not None:
            out[d.parent.name] = (d.name, int(d.factor or 1))
    return out


def _free_dims(eq):
    """Reduction dimensions: rhs space dims absent from the target — an
    ``Inc`` over them is a contraction. Returns {dim name: (0, extent)}
    in a deterministic order."""
    from ..types.basic import retrieve_functions
    target_names = {(d.root.name if getattr(d, 'is_Sub', False) else d.name)
                    for d in eq.target.space_dimensions}
    target_names.update(_stride_map(eq))
    out = OrderedDict()
    for a in retrieve_functions(eq.rhs):
        f = a.function
        if f.is_SparseFunction:
            continue
        sdims = f.space_dimensions
        sshape = f.shape[len(f.shape) - len(sdims):]  # drop time axis
        oofs = getattr(f, 'origin_offset', None) or (0,) * len(sdims)
        for d, n, oo in zip(sdims, sshape, oofs):
            dn = d.root.name if getattr(d, 'is_Sub', False) else d.name
            if dn not in target_names and dn not in out:
                out[dn] = (oo, int(n))
    return out


def _as_tensor(val, like):
    return torch.as_tensor(val, dtype=like.dtype, device=like.device)


def _finalize_val(eq, val, cur, ctx):
    """The region's new values: ``val`` combined with the current ones
    ``cur`` by the equation's reduction, increment and condition."""
    from .translate import translate
    val = _as_tensor(val, cur)
    if eq.reduction == 'max':
        val = torch.maximum(cur, val)
    elif eq.reduction == 'min':
        val = torch.minimum(cur, val)
    elif eq.increment:
        val = cur + val
    if eq.condition is not None:
        cond = torch.as_tensor(translate(eq.condition, ctx),
                               device=cur.device)
        val = torch.where(cond, val, cur)
    return val.expand(cur.shape)


def plan_rows(plan, bufs, t, params):
    """The rows a stencil-kernel update of ``plan`` reads and writes at
    step ``t``: ``(target row, [row per access group])``, all views of
    the tensors in ``bufs``."""
    return (_target_row(plan.eq, bufs, t, params),
            [_resolve_time_indexed(bufs, g['fn'], g['tk'], g['toff'], t,
                                   params) for g in plan.groups])


def _exec_dense(eq, plan, bufs, params, t):
    if not _write_due(eq, bufs, t, params):
        return
    if plan is not None:
        stencil_update(plan, plan_rows(plan, bufs, t, params), params)
        return
    target = _target_row(eq, bufs, t, params)

    from .translate import translate, DenseCtx
    region = _region_map(eq)
    free = _free_dims(eq)
    if free:
        region = OrderedDict(list(region.items()) + list(free.items()))
    ctx = DenseCtx(bufs, params, region, t=t, stride_map=_stride_map(eq),
                   device=target.device)
    val = translate(eq.rhs, ctx)
    if free:
        ax = tuple(range(len(region) - len(free), len(region)))
        if eq.reduction == 'max':
            val = torch.amax(val, dim=ax)
        elif eq.reduction == 'min':
            val = torch.amin(val, dim=ax)
        else:
            val = torch.sum(val, dim=ax)
    dst = target[_write_region_slices(eq)]
    val = _finalize_val(eq, val, widen(dst, eq.target), ctx)
    if val.untyped_storage().data_ptr() == \
            target.untyped_storage().data_ptr():
        # a bare read of the target's own buffer: copy before writing
        val = val.clone()
    dst.copy_(val)


def _sparse_geometry(sf, bufs, params):
    """Corner indices {dim: (C, P) int64 tensor, domain coords, clipped}
    and weights (C, P) of a sparse function's interpolation stencil, from
    the runtime coordinates tensor (reference: WeightedInterpolator,
    operations/interpolators.py:210) or, for precomputed and matrix
    functions, from their gridpoints and coefficient tables (reference:
    PrecomputedInterpolator:555, MatrixSparseTimeFunction: the gridpoint
    is the minimum index, the points ``gridpoint + i`` for i in [0,
    ncoeffs)). A point outside ``[0, n-1]`` in any axis gets zero weight;
    clipped duplicate corners accumulate."""
    grid = sf.grid
    interp = sf.interpolator
    per_dim = []
    valid = None
    if getattr(interp, 'name', '') in ('precomputed', 'matrix'):
        for j, d in enumerate(grid.dimensions):
            n = grid.shape[j]
            offsets, coeffs, gp = interp.dim_weights_precomputed(j)
            v = (gp >= 0) & (gp <= n - 1)
            valid = v if valid is None else (valid & v)
            per_dim.append((d, offsets, coeffs.unbind(1), gp, n))
    else:
        coords = bufs[f"{sf.name}_coords"]
        for j, d in enumerate(grid.dimensions):
            h = float(params.get(d.spacing.name, grid.spacing[j]))
            o = float(grid.origin[j])
            n = grid.shape[j]
            px = (coords[:, j] - o) / h  # position in grid points (P,)
            offsets, wlist, base = interp.dim_weights(px)
            v = (px >= 0) & (px <= n - 1)
            valid = v if valid is None else (valid & v)
            per_dim.append((d, offsets, wlist, base, n))

    corner_idx = {d.name: [] for d, *_ in per_dim}
    weights = []
    for combo in product(*[range(len(p[1])) for p in per_dim]):
        w = None
        for (d, offsets, wlist, base, n), c in zip(per_dim, combo):
            corner_idx[d.name].append(torch.clamp(base + offsets[c], 0,
                                                  n - 1))
            w = wlist[c] if w is None else w * wlist[c]
        weights.append(w)
    W = torch.stack(weights) * valid.to(weights[0].dtype)  # (C, P)
    return {k: torch.stack(v) for k, v in corner_idx.items()}, W


def _matmul(m, v):
    """``m @ v``, ``v`` a tensor or scalar broadcast to m's columns, in the
    promoted dtype of the two (a matrix function's coupling: its matrix,
    on the device, against the values)."""
    v = torch.as_tensor(v, device=m.device)
    dt = torch.promote_types(m.dtype, v.dtype)
    return m.to(dt) @ v.to(dt).expand(m.shape[1:])


def _write_interp(item, sf, res, bufs, t, matrix):
    """Store the (P,) interpolated values into the sparse rows; a matrix
    function's channels are ``matrix^T @`` its locations' values."""
    buf = bufs[sf.name]
    if matrix is not None:
        res = _matmul(matrix.T, res)
    res = _as_tensor(res, buf).expand(buf.shape[-1:])
    if sf.is_SparseTimeFunction:
        td = sf.dimensions[0]
        factor = (td.factor or 1) if getattr(td, 'is_Conditional',
                                             False) else 1
        if factor > 1 and t % factor:
            return  # subsampled recording: every factor-th step
        dst = buf[(t // factor if factor > 1 else t)
                  + item.target_time_off]
    else:
        dst = buf
    if item.increment:
        dst += res
    else:
        dst.copy_(res)


def _separable_terms(item, sf, bufs):
    """``[(coeff, fn, time kind, time offset, band slices), ...]``: the
    terms of ``item``'s sampled expression and the band of each one's row
    the separable contraction reads; or None when the path cannot take the
    expression -- not a linear combination of dense accesses, a function
    not on the whole grid, or a tap whose domain window leaves the
    allocation -- and the gather serves it (the reference's rule)."""
    from ..operations.separable import linear_terms
    from ..ir.lowering import time_access_of, space_offsets_of
    from ..exceptions import InvalidOperator
    sep = bufs[f'{sf.name}_sep']
    terms = linear_terms(item.expr)
    if terms is None:
        return None
    shape = tuple(sf.grid.shape)
    out = []
    for coeff, a in terms:
        fn = a.function
        try:
            offs = space_offsets_of(a)
        except InvalidOperator:
            return None
        if len(offs) != len(shape) or tuple(fn.shape[-len(shape):]) != \
                shape or any(fn.origin_offset):
            return None
        ext = fn._allocated_space()
        slices = []
        for (hl, _), off, n, e, lo, M in zip(fn.halo, offs, shape, ext,
                                             sep.lo, sep.M):
            s = hl + int(off)
            if s < 0 or s + n > e:
                return None    # an offset tap outside the allocation
            slices.append(slice(s + lo, s + lo + M.shape[0]))
        tk, toff = time_access_of(a)
        out.append((coeff, fn, tk, toff, tuple(slices)))
    return out


def _interp_separable(terms, sep, bufs, params, t):
    """The (P,) interpolated values of ``terms`` (``_separable_terms``):
    their bands, widened to the weights' dtype, summed with their
    coefficients, then contracted once (``separable.contract``)."""
    from ..operations.separable import contract
    acc = None
    for coeff, fn, tk, toff, slices in terms:
        row = _resolve_time_indexed(bufs, fn, tk, toff, t, params)
        band = row[slices].to(sep.M[0].dtype)
        acc = coeff * band if acc is None else acc + coeff * band
    return contract(acc, sep)


def _exec_sparse(item, bufs, params, t, geom_cache):
    from .translate import translate, SparseCtx

    sf = item.sparse
    if item.kind == 'interp' and f'{sf.name}_sep' in bufs:
        key = ('sep', id(item))
        if key not in geom_cache:
            geom_cache[key] = _separable_terms(item, sf, bufs)
        terms = geom_cache[key]
        if terms is not None:
            res = _interp_separable(terms, bufs[f'{sf.name}_sep'], bufs,
                                    params, t)
            return _write_interp(item, sf, res, bufs, t, None)
    if sf.name not in geom_cache:
        # a matrix function's matrix goes to the device once an apply,
        # with its geometry
        matrix = getattr(type(sf), '_matrix', None)
        geom_cache[sf.name] = _sparse_geometry(sf, bufs, params) + (
            None if matrix is None else
            torch.as_tensor(matrix, device=bufs[sf.name].device),)
    corner_idx, W, matrix = geom_cache[sf.name]
    ctx = SparseCtx(bufs, params, corner_idx, W, sf, t=t)
    val = translate(item.expr, ctx)  # (C, P), (P,) or scalar

    if item.kind == 'interp':
        res = torch.sum(W * val, dim=0)
        return _write_interp(item, sf, res, bufs, t, matrix)
    field = item.field
    buf = bufs[field.name]
    if item.field_time_kind == 'stepping':
        buf = buf[step_row(t, item.field_time_off or 0, field._time_size)]
    elif item.field_time_kind == 'save':
        buf = buf[save_row(t, item.field_time_off, params, field)]
    sidx = tuple(corner_idx[d.name] + hl
                 for d, (hl, hr) in zip(field.space_dimensions, field.halo))
    if matrix is not None:
        # a location's values: matrix @ the channels' values
        val = _matmul(matrix, val)
    # accumulate: clipped duplicate corners must add up; into a narrow
    # buffer the contributions round to its dtype first, as the
    # reference's scatter-add does
    buf.index_put_(sidx, (W * val).to(buf.dtype), accumulate=True)


#: The stability scan's period in steps (reference: errctl='max').
ERRCTL_PERIOD = 100


def _unstable(bufs, names):
    """True when slot 0 of a buffer of ``names`` sums to a non-finite
    value (a narrow buffer sums in fp32): one device reduction each and
    one host read."""
    ok = [torch.isfinite(bufs[n][0].sum(
        dtype=torch.float32 if bufs[n].dtype in (torch.bfloat16,
                                                  torch.float16) else None))
          for n in names]
    return not bool(torch.stack(ok).all())


def build_runner(schedule, storage=None, errctl=None, sections=None):
    """Build ``run(bufs, params, time_m, time_M, tags=False)``, which
    updates the tensors of ``bufs`` (by function name; ``<name>_coords``
    for sparse coordinates, ``<name>_sep`` for a factorised geometry) in
    place. The stencil-kernel decision is taken here, once per dense
    equation, with ``storage`` ({function name: torch dtype} of the narrow
    ones); ``run.plans`` lists ``(eq, plan or None)``. With ``errctl``
    (names of written stepping functions) ``run`` returns the step whose
    stability check failed, else None.

    With ``tags`` each body item runs inside a ``torch.profiler.
    record_function`` range named by ``sections`` (one name a body item;
    by default ``dtpu_sec<i>``, numbered as Operator._estimate_flops
    numbers its sections), which operator/trace_profile.py reads back;
    the prologue and epilogue run untagged. Without, no range is opened.
    """
    plans = OrderedDict()
    for it in schedule.all_items:
        if isinstance(it, LoweredEq):
            plans[id(it)] = (it, plan_for(it, storage=storage))
    direction = schedule.direction
    if sections is None:
        sections = [f'dtpu_sec{i}' for i in range(len(schedule.body))]
    tagged = list(zip(schedule.body, sections))

    def _exec_items(items, bufs, params, t, geom_cache):
        for it in items:
            if isinstance(it, LoweredEq):
                _exec_dense(it, plans[id(it)][1], bufs, params, t)
            elif isinstance(it, LoweredSparse):
                _exec_sparse(it, bufs, params, t, geom_cache)
            else:
                raise CompilationError(f"Cannot execute {it}")

    def _exec_tagged(bufs, params, t, geom_cache):
        for it, name in tagged:
            with record_function(name):
                _exec_items((it,), bufs, params, t, geom_cache)

    def run(bufs, params, time_m, time_M, tags=False):
        geom_cache = {}
        halted = None
        _exec_items(schedule.prologue, bufs, params, None, geom_cache)
        if schedule.body:
            anchor = time_m if direction >= 0 else time_M
            for i in range(max(time_M - time_m + 1, 0)):
                t = anchor + direction * i
                if tags:
                    _exec_tagged(bufs, params, t, geom_cache)
                else:
                    _exec_items(schedule.body, bufs, params, t, geom_cache)
                if errctl and t % ERRCTL_PERIOD == 0 and \
                        _unstable(bufs, errctl):
                    halted = t
                    break
        _exec_items(schedule.epilogue, bufs, params, None, geom_cache)
        return halted

    run.plans = list(plans.values())
    return run
