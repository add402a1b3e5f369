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
  and runs its plain PyTorch version on CPU tensors; consecutive body
  equations that K1 fuses (``plan_run``) share one plan, launched once at
  the first of them;
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

from ..ir.lowering import LoweredEq, LoweredSparse
from ..exceptions import CompilationError
from ..kernels.stencil import plan_for, plan_run, stencil_update
from ..types.dense import widen
from ..utils import span

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
    step ``t``: ``(target row, [row per access group])`` -- a fused unit's
    target rows as a list, one an equation -- all views of the tensors in
    ``bufs``."""
    outs = [_target_row(eq, bufs, t, params) for eq in plan.eqs]
    return (outs if plan.nt > 1 else outs[0],
            [_resolve_time_indexed(bufs, g['fn'], g['tk'], g['toff'], t,
                                   params) for g in plan.groups])


def _dense_value(eq, bufs, params, t, shard=None):
    """``(target row, value over the region, translate context)`` of a
    dense eq the torch translator runs; the value is reduced over the free
    (contraction) dimensions. On a shard (``(Shard, parts)``) a free
    partitioned dimension spans the shard's local extent, and its dead
    cells (global index past the domain) are masked out of the reduction
    with a where, not a product: a dead cell may hold inf or nan (1/f of a
    zero pad), and 0 * inf would poison the combined sum."""
    target = _target_row(eq, bufs, t, params)

    from .translate import translate, DenseCtx
    region = _region_map(eq)
    free = _free_dims(eq)
    parts = shard[1] if shard is not None else {}
    if free:
        free = OrderedDict((dn, (0, parts[dn][2]) if dn in parts else ext)
                           for dn, ext in free.items())
        region = OrderedDict(list(region.items()) + list(free.items()))
    ctx = DenseCtx(bufs, params, region, t=t, stride_map=_stride_map(eq),
                   device=target.device)
    val = translate(eq.rhs, ctx)
    if free:
        nt_ax = len(region) - len(free)
        val = _as_tensor(val, target)
        for k, dn in enumerate(free):
            if dn not in parts or shard[0].live[dn] == parts[dn][2]:
                continue
            shp = [1] * max(val.dim(), len(region))
            shp[nt_ax + k] = parts[dn][2]
            live = (torch.arange(parts[dn][2], device=val.device) <
                    shard[0].live[dn]).reshape(shp)
            fill = 0
            if eq.reduction in ('max', 'min'):
                info = torch.finfo(val.dtype)
                fill = info.min if eq.reduction == 'max' else info.max
            val = torch.where(live, val, torch.tensor(fill, dtype=val.dtype,
                                                      device=val.device))
        ax = tuple(range(nt_ax, len(region)))
        if eq.reduction == 'max':
            val = torch.amax(val, dim=ax)
        elif eq.reduction == 'min':
            val = torch.amin(val, dim=ax)
        else:
            val = torch.sum(val, dim=ax)
    return target, val, ctx


def _dense_store(eq, target, val, ctx):
    """Combine ``val`` with the region's current values (reduction,
    increment, condition) and write it into ``target``."""
    dst = target[_write_region_slices(eq)]
    val = _finalize_val(eq, val, widen(dst, eq.target), ctx)
    if val.untyped_storage().data_ptr() == \
            target.untyped_storage().data_ptr():
        # a bare read of the target's own buffer: copy before writing
        val = val.clone()
    dst.copy_(val)


def _exec_dense(eq, plan, bufs, params, t):
    if not _write_due(eq, bufs, t, params):
        return
    if plan is not None:
        stencil_update(plan, plan_rows(plan, bufs, t, params), params)
        return
    _dense_store(eq, *_dense_value(eq, bufs, params, t))


def _sparse_geometry(sf, bufs, params, shard=None):
    """Corner indices {dim: (C, P) int64 tensor, domain coords, clipped}
    and weights (C, P) of a sparse function's interpolation stencil, from
    the runtime coordinates tensor (reference: WeightedInterpolator,
    operations/interpolators.py:210) or, for precomputed and matrix
    functions, from their gridpoints and coefficient tables (reference:
    PrecomputedInterpolator:555, MatrixSparseTimeFunction: the gridpoint
    is the minimum index, the points ``gridpoint + i`` for i in [0,
    ncoeffs)). A point outside ``[0, n-1]`` in any axis gets zero weight;
    clipped duplicate corners accumulate.

    On a shard (``(Shard, parts)``; devito_tpu: executor.py:1199-1282) the
    geometry covers the points of the shard's owner bucket
    (``<name>_own``) where there is one, and every corner is localized: the
    shard's offset subtracted, a corner the shard does not own masked out
    of W. Returns (corner_idx, W, own): ``own`` the bucket or None."""
    grid = sf.grid
    interp = sf.interpolator
    own = bufs.get(f'{sf.name}_own') if shard is not None else None
    per_dim = []
    valid = None
    if getattr(interp, 'name', '') in ('precomputed', 'matrix'):
        own = None
        for j, d in enumerate(grid.dimensions):
            n = grid.shape[j]
            offsets, coeffs, gp = interp.dim_weights_precomputed(j)
            v = (gp >= 0) & (gp <= n - 1)
            valid = v if valid is None else (valid & v)
            per_dim.append((d, offsets, coeffs.unbind(1), gp, n))
    else:
        coords = bufs[f"{sf.name}_coords"]
        if own is not None:
            coords = coords[own]
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
    idxs = {k: torch.stack(v) for k, v in corner_idx.items()}
    if shard is not None:
        sh, parts = shard
        for dn, (_, _, lext, _) in parts.items():
            loc = idxs[dn] - sh.offsets[dn]
            W = W * ((loc >= 0) & (loc <= lext - 1)).to(W.dtype)
            idxs[dn] = torch.clamp(loc, 0, lext - 1)
    return idxs, W, own


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


def _sparse_value(item, bufs, params, t, geom_cache, shard=None):
    """``(sparse function, values, geometry)`` of a sparse item: for an
    interpolation the (P,) values (on a shard, its partial sums, scattered
    to the global point slots), for an injection the (C, P) contributions
    ``W * val``."""
    from .translate import translate, SparseCtx

    sf = item.sparse
    if sf.name not in geom_cache:
        # a matrix function's matrix goes to the device once an apply,
        # with its geometry
        matrix = getattr(type(sf), '_matrix', None)
        geom_cache[sf.name] = _sparse_geometry(sf, bufs, params, shard) + (
            None if matrix is None else
            torch.as_tensor(matrix, device=bufs[sf.name].device),)
    corner_idx, W, own, matrix = geom_cache[sf.name]
    ctx = SparseCtx(bufs, params, corner_idx, W, sf, t=t, own=own)
    val = translate(item.expr, ctx)  # (C, P), (P,) or scalar

    if item.kind == 'interp':
        res = torch.sum(W * val, dim=0)
        if own is not None:
            # the shard's owned points back to their global slots
            res = torch.zeros(sf.npoint, dtype=res.dtype,
                              device=res.device).index_add_(
                0, own, res.expand(own.shape))
        return sf, res, (corner_idx, W, matrix)
    if matrix is not None:
        # a location's values: matrix @ the channels' values
        val = _matmul(matrix, val)
    return sf, W * val, (corner_idx, W, matrix)


def _inject(item, bufs, params, t, contrib, corner_idx):
    """Scatter-add the (C, P) contributions into the field's row."""
    field = item.field
    buf = bufs[field.name]
    if item.field_time_kind == 'stepping':
        buf = buf[step_row(t, item.field_time_off or 0, field._time_size)]
    elif item.field_time_kind == 'save':
        buf = buf[save_row(t, item.field_time_off, params, field)]
    sidx = tuple(corner_idx[d.name] + hl
                 for d, (hl, hr) in zip(field.space_dimensions, field.halo))
    # accumulate: clipped duplicate corners must add up; into a narrow
    # buffer the contributions round to its dtype first, as the
    # reference's scatter-add does
    buf.index_put_(sidx, contrib.to(buf.dtype), accumulate=True)


#: a sparse item's span, by its kind
SPARSE_SPANS = {'inject': 'dtpu::sparse.inject',
                'interp': 'dtpu::sparse.interp'}


def _exec_sparse(item, bufs, params, t, geom_cache):
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
    sf, val, (corner_idx, W, matrix) = _sparse_value(item, bufs, params, t,
                                                     geom_cache)
    if item.kind == 'interp':
        return _write_interp(item, sf, val, bufs, t, matrix)
    _inject(item, bufs, params, t, val, corner_idx)


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


def _time_loop(schedule, tagged, exec_item, unstable, bufs, params, time_m,
               time_M, cache):
    """Run ``schedule`` over ``[time_m, time_M]``: its prologue, then each
    step's body items, each inside the span its ``tagged`` name gives it,
    then its epilogue; the prologue and epilogue run outside the sections
    (``exec_item(it, bufs, params, t, cache)``, t None for them). With
    ``unstable`` (a test of ``bufs``), it runs after every step t with t
    mod ERRCTL_PERIOD == 0, and the first that holds ends the steps.
    Returns that step, or None."""
    halted = None
    for it in schedule.prologue:
        exec_item(it, bufs, params, None, cache)
    if schedule.body:
        direction = schedule.direction
        anchor = time_m if direction >= 0 else time_M
        for i in range(max(time_M - time_m + 1, 0)):
            t = anchor + direction * i
            for it, name in tagged:
                with span(name):
                    exec_item(it, bufs, params, t, cache)
            if unstable is not None and t % ERRCTL_PERIOD == 0 and \
                    unstable(bufs):
                halted = t
                break
    for it in schedule.epilogue:
        exec_item(it, bufs, params, None, cache)
    return halted


def build_runner(schedule, storage=None, errctl=None, sections=None,
                 shard_spec=None):
    """Build ``run(bufs, params, time_m, time_M)``, which
    updates the tensors of ``bufs`` (by function name; ``<name>_coords``
    for sparse coordinates, ``<name>_sep`` for a factorised geometry) in
    place. The stencil-kernel decision is taken here, once per dense
    equation, with ``storage`` ({function name: torch dtype} of the narrow
    ones): each run of consecutive dense items of the body goes to K1's
    ``plan_run``, which may fuse some of them into one unit, the others
    to ``plan_for``. ``run.plans`` lists ``(eq, plan or None)``, a fused
    unit's plan beside each of its equations. With ``errctl``
    (names of written stepping functions) ``run`` returns the step whose
    stability check failed, else None.

    Each body item runs inside a ``span`` (utils/tools.py) named by
    ``sections`` (one name a body item; by default ``dtpu_sec<i>``,
    numbered as Operator._estimate_flops numbers its sections), which
    operator/trace_profile.py reads back: a ``torch.profiler`` range while
    a profiler records, nothing otherwise. A fused unit launches in its
    first equation's section; the others' sections stay, empty. The
    prologue and epilogue run outside the sections.

    With ``shard_spec`` (a parallel/halo.py ShardedRunner) the schedule is
    its local schedule and ``run`` takes one dict of tensors a shard
    (``_build_sharded``).
    """
    if shard_spec is not None:
        return _build_sharded(schedule, storage, errctl, sections,
                              shard_spec)
    plans = OrderedDict()
    body = {id(it) for it in schedule.body}
    run_ = []       # consecutive dense items of the body; None ends the last
    for it in schedule.all_items + [None]:
        if isinstance(it, LoweredEq) and id(it) in body:
            run_.append(it)
            continue
        for eq, plan in zip(run_, plan_run(run_, storage=storage)):
            plans[id(eq)] = (eq, plan)
        run_ = []
        if isinstance(it, LoweredEq):
            plans[id(it)] = (it, plan_for(it, storage=storage))
    if sections is None:
        sections = [f'dtpu_sec{i}' for i in range(len(schedule.body))]
    tagged = list(zip(schedule.body, sections))
    unstable = (lambda bufs: _unstable(bufs, errctl)) if errctl else None

    def _exec_item(it, bufs, params, t, geom_cache):
        if isinstance(it, LoweredEq):
            plan = plans[id(it)][1]
            # a fused unit's later equations ran in its first one's launch
            if plan is None or plan.eq is it:
                _exec_dense(it, plan, bufs, params, t)
        elif isinstance(it, LoweredSparse):
            with span(SPARSE_SPANS[it.kind]):
                _exec_sparse(it, bufs, params, t, geom_cache)
        else:
            raise CompilationError(f"Cannot execute {it}")

    def run(bufs, params, time_m, time_M):
        return _time_loop(schedule, tagged, _exec_item, unstable, bufs,
                          params, time_m, time_M, {})

    run.plans = list(plans.values())
    return run


def _bound_of(rel, parts):
    """``(dim name, lo, hi)`` when ``rel`` bounds a partitioned dimension by
    an integer (``d >= a``, ``d > a``, ``d < b``, ``d <= b``): the global
    range ``[lo, hi)`` it keeps; else None."""
    import sympy
    from ..types.dimension import Dimension
    ops = {sympy.GreaterThan: (0, None), sympy.StrictGreaterThan: (1, None),
           sympy.StrictLessThan: (None, 0), sympy.LessThan: (None, 1)}
    flip = {sympy.GreaterThan: sympy.LessThan,
            sympy.StrictGreaterThan: sympy.StrictLessThan,
            sympy.StrictLessThan: sympy.StrictGreaterThan,
            sympy.LessThan: sympy.GreaterThan}
    for cls in ops:
        if isinstance(rel, cls):
            lhs, rhs = rel.lhs, rel.rhs
            if isinstance(rhs, Dimension) and not isinstance(lhs, Dimension):
                lhs, rhs, cls = rhs, lhs, flip[cls]
            if not isinstance(lhs, Dimension) or lhs.name not in parts or \
                    not getattr(rhs, 'is_Integer', False):
                return None
            lo, hi = ops[cls]
            c = int(rhs)
            return (lhs.name, None if lo is None else c + lo,
                    None if hi is None else c + hi)
    return None


def shard_item(eq, shard, parts):
    """``eq`` (an item of the local schedule) as ``shard`` runs it, or None
    when it writes nothing there: on each partitioned axis its region is
    clamped to the global domain and to the bounds its condition puts on
    the dimension (the local schedule's masks for sub-domain writes and
    the uneven last shard, ``d >= a`` and ``d < b`` in global coordinates),
    and those bounds leave the condition. The clamp writes what the masks
    let through, so the stencil kernel can take the item; it also keeps a
    ghost-zone extension inside the domain on the outermost shards, where
    the whole run's halo stays zero. An item whose global region
    (``global_region``) reaches past the domain into the halo -- CIRE's
    temporaries, hoisted prologue items -- reaches as far past it on the
    outermost shards, where its region touches the domain's edge, as the
    whole run computes it there."""
    import sympy
    from copy import copy
    cond = eq.condition
    own = {d.name for d in eq.target.space_dimensions}
    bounds = {}
    rest = []
    if cond is not None:
        for a in (cond.args if isinstance(cond, sympy.And) else (cond,)):
            b = _bound_of(a, parts)
            if b is None or b[0] not in own:
                rest.append(a)
                continue
            lo, hi = bounds.get(b[0], (None, None))
            if b[1] is not None:
                lo = b[1] if lo is None else max(lo, b[1])
            if b[2] is not None:
                hi = b[2] if hi is None else min(hi, b[2])
            bounds[b[0]] = (lo, hi)
    glob = getattr(eq, 'global_region', None) or eq.region
    region = []
    for d, (a, b), (ga, gb) in zip(eq.target.space_dimensions, eq.region,
                                   glob):
        part = parts.get(d.name)
        if part is not None:
            n, off = part[3], shard.offsets[d.name]
            lo, hi = bounds.get(d.name, (None, None))
            lo = 0 if lo is None else max(lo, 0)
            hi = n if hi is None else min(hi, n)
            edge_lo = ga < 0 and off == 0 and a <= 0
            edge_hi = gb > n and off < n <= off + part[2] and \
                b >= n - off
            a = ga if edge_lo else max(a, lo - off)
            b = gb - off if edge_hi else min(b, hi - off)
        if b <= a:
            return None
        region.append((a, b))
    if not bounds and tuple(region) == tuple(eq.region):
        return eq
    new = copy(eq)
    new.region = tuple(region)
    new.condition = (None if not rest else
                     rest[0] if len(rest) == 1 else sympy.And(*rest))
    return new


def _combine(vals, op):
    """``vals`` (one tensor a shard, in mesh order) combined on the first's
    device: their sum, max or min (devito_tpu: psum, pmax, pmin)."""
    out = vals[0]
    for v in vals[1:]:
        v = v.to(out.device)
        out = torch.maximum(out, v) if op == 'max' else \
            torch.minimum(out, v) if op == 'min' else out + v
    return out


def _build_sharded(schedule, storage, errctl, sections, spec):
    """The runner of a ShardedRunner's local schedule:
    ``run(sbufs, params, time_m, time_M)`` over ``sbufs``, one
    dict of tensors a shard (``spec.prepare_buffers``), in place.

    Each item runs on every shard in turn, as ``shard_item`` gives it to
    that shard; its stencil-kernel plans are planned once for the shards'
    local layout (``spec.local_space``) and shared by the shards an item
    gives the same region. An exchange marker runs once with every shard's
    tensors. A contraction or reduction over partitioned dimensions
    combines its shards' partials across the shards that share the
    target's cells, an interpolation adds every shard's partial sums
    (devito_tpu: executor.py:997-1034, 1411-1421), and under errctl one
    shard's failed check halts every shard. ``run.plans`` lists the
    distinct ``(eq, plan or None)``; ``run.shard_plans`` has ``(shard
    index, item, eq, plan)`` for each shard's dense item."""
    shards, parts = spec.shards, spec.parts
    dims = [d.name for d in spec.grid.dimensions]
    plans = OrderedDict()
    per = {}            # id(item) -> [(eq, plan) or None per shard]
    shard_plans = []
    for it in schedule.all_items:
        if not isinstance(it, LoweredEq):
            continue
        row = []
        for sh in shards:
            eq = shard_item(it, sh, parts)
            if eq is None:
                row.append(None)
                continue
            key = (id(it), eq.region, str(eq.condition))
            if key not in plans:
                plans[key] = (eq, plan_for(eq, storage=storage,
                                           space=spec.local_space))
            eq, plan = plans[key]
            row.append((eq, plan))
            shard_plans.append((sh.index, it, eq, plan))
        per[id(it)] = row
    tagged = list(zip(schedule.body, sections))
    unstable = (lambda sbufs: any(_unstable(b, errctl) for b in sbufs)) \
        if errctl else None

    def groups(axes):
        """The shards by their mesh coordinates off ``axes``: each group
        shares a reduction target's cells."""
        out = OrderedDict()
        for sh in shards:
            key = tuple(c for j, c in enumerate(sh.coords)
                        if dims[j] not in axes)
            out.setdefault(key, []).append(sh.index)
        return list(out.values())

    def dense(it, sbufs, sparams, t):
        row = per[id(it)]
        if not _write_due(it, sbufs[0], t, sparams[0]):
            return
        axes = {dn for dn in _free_dims(it) if dn in parts}
        if not axes:
            for sh, e in zip(shards, row):
                if e is not None:
                    _exec_dense(e[0], e[1], sbufs[sh.index],
                                sparams[sh.index], t)
            return
        for group in groups(axes):
            got = [(i, _dense_value(row[i][0], sbufs[i], sparams[i], t,
                                    (shards[i], parts)))
                   for i in group if row[i] is not None]
            if not got:
                continue
            tot = _combine([v[1] for _, v in got], it.reduction)
            for i, (target, _, ctx) in got:
                _dense_store(row[i][0], target, tot.to(target.device), ctx)

    def sparse(it, sbufs, sparams, t, geoms):
        vals = [_sparse_value(it, sbufs[sh.index], sparams[sh.index], t,
                              geoms[sh.index], (sh, parts))
                for sh in shards]
        if it.kind == 'interp':
            tot = _combine([v[1] for v in vals], 'sum')
            for sh, (sf, _, geo) in zip(shards, vals):
                _write_interp(it, sf, tot.to(sh.device), sbufs[sh.index], t,
                              geo[2])
            return
        for sh, (sf, contrib, geo) in zip(shards, vals):
            _inject(it, sbufs[sh.index], sparams[sh.index], t, contrib,
                    geo[0])

    def _exec_item(it, sbufs, sparams, t, geoms):
        if isinstance(it, LoweredEq):
            dense(it, sbufs, sparams, t)
        elif isinstance(it, LoweredSparse):
            with span(SPARSE_SPANS[it.kind]):
                sparse(it, sbufs, sparams, t, geoms)
        elif getattr(it, 'kind', None) == 'halo':
            it.run(sbufs, sparams, t)
        else:
            raise CompilationError(f"Cannot execute {it}")

    def run(sbufs, params, time_m, time_M):
        sparams = [dict(params, **sh.params) for sh in shards]
        return _time_loop(schedule, tagged, _exec_item, unstable, sbufs,
                          sparams, time_m, time_M, [{} for _ in shards])

    run.plans = [(eq, plan) for eq, plan in plans.values()]
    run.shard_plans = shard_plans
    return run
