"""The Operator: lowering + runtime arguments + execution.

Reference parity: devito/operator/operator.py (Operator:54 — _lower
pipeline, _prepare_arguments:583, apply:956).

Pipeline: expressions -> evaluate (FD expansion) -> LoweredEq/LoweredSparse
schedule (ir/lowering.py) -> a runner (compiler/executor.py) whose time
loop updates the functions' tensors in place. Building the runner decides,
per dense equation, whether it runs in the stencil kernel. ``apply`` binds
tensors, parameters and time bounds; nothing in it rebuilds the runner or
a kernel, but for spatial bounds (``x_m``/``x_M``, ``x=``): a runner over
the clamped regions, built once a set of bounds, whose kernels are the
same units with other launch arguments.

What ``apply`` does besides (reference: devito_tpu/operator/operator.py):
narrow wavefield storage (``storage-dtype``, ``_storage_map``), the
separable interpolation's set-up (``configuration['separable']``), the
errctl stability scan (``ExecutionError``) and the ``autotune`` argument,
which has no tuner here and runs untuned, as devito_tpu's Pallas backend
does. Host streaming of ``save=nt`` wavefields (``save-streaming``,
``save-budget``; ``_plan_streaming``, ``_apply_streamed``): the loop runs
in chunks with only a window of each save buffer on the device. Measured
profiling (``profiling='measured'``, ``profile-dir``): the loop runs under
torch.profiler and each section gets its device time from the trace
(operator/trace_profile.py). The log line gives the share of the device
memory roofline of the card's arch.py row. An Operator pickles: the
runner, its kernel plans, the bounded runners, the sharded runner and the
streaming plan are left out and built again when it is unpickled, from the
same units (kernels/_nvcc.py keys).

A function override of another halo than the Operator's function
(``apply(f=g)``, ``g`` of ``f``'s shape and dtype) runs on a copy of the
Operator whose schedule accesses ``g``'s function, with a runner planned
for its layout, built once a layout (``_relaid``); ``ccode`` shows the
generated code of each item.

On a distributed Grid (``Grid(topology=...)``) ``apply`` runs the
schedule sharded (parallel/halo.py ``ShardedRunner``, built at the first
apply, ``_halo_runner_for``): the shards are cut from the functions' whole
tensors, the local schedule runs on every shard with the halo exchange
between them, and the shards' interiors are written back. A schedule
``explicit_halo_eligible`` rejects runs gathered under
``configuration['halo'] = 'auto'`` (the unsharded runner on the whole
tensors; the reason is logged and kept in ``halo_decline``, the applies
counted in ``gathered_applies``) and raises under 'explicit'.
"""

import copy as _copy
import os
import shutil
import tempfile
import time as _time
from collections import OrderedDict

import numpy as np
import sympy
import torch

from ..ir.lowering import (LoweredEq, LoweredSparse, Schedule,
                           lower_expressions, estimate_cost, time_access_of,
                           rebind, space_offsets_of)
from ..compiler.executor import build_runner
from ..types.basic import AbstractFunction, retrieve_functions
from ..types.constant import Constant
from ..types.dimension import Dimension
from ..exceptions import InvalidArgument, ExecutionError
from ..logger import perf as log_perf, debug, warning
from ..parameters import configuration
from ..types.dense import (storage_torch_dtype, torch_dtype, _stamp,
                           _seconds)
from ..utils import span
from .profiling import PerformanceSummary

__all__ = ['Operator']

#: ``opt`` options that steer the CIRE and invariant-hoisting passes.
LOWERING_OPTIONS = ('cire', 'hoist-invariants', 'hoist-trig-taps')
#: ``opt`` options of the run: narrow storage and its scope, the errctl
#: stability scan, with the values each takes.
RUN_OPTIONS = {'storage-dtype': None,
               'storage-dtype-scope': ('fields', 'all'),
               'errctl': (None, 'max')}


def _parse_opt(opt):
    """``(mode, options)`` of an ``opt`` argument: a mode string, or a
    tuple of a mode and option dicts. Raises InvalidArgument on an unknown
    mode, on any option outside ``LOWERING_OPTIONS`` and ``RUN_OPTIONS``,
    and on a value a run option does not take."""
    mode, options = opt, {}
    if isinstance(opt, (tuple, list)):
        mode = opt[0] if opt else None
        for o in opt[1:]:
            if not isinstance(o, dict):
                raise InvalidArgument(f"opt options must be dicts, got {o!r}")
            options.update(o)
    mode = mode or configuration['opt']
    if mode not in ('noop', 'advanced'):
        raise InvalidArgument(f"Unknown opt mode {mode!r}")
    for k, v in options.items():
        if k not in LOWERING_OPTIONS and k not in RUN_OPTIONS:
            raise InvalidArgument(f"Unknown opt option {k!r}")
        accepted = RUN_OPTIONS.get(k)
        if accepted is not None and v not in accepted:
            raise InvalidArgument(f"opt option {k!r} takes one of "
                                  f"{accepted}, got {v!r}")
    if options.get('storage-dtype') is not None:
        try:
            storage_torch_dtype(options['storage-dtype'])
        except TypeError:
            raise InvalidArgument(f"Unknown storage-dtype "
                                  f"{options['storage-dtype']!r}")
    return mode, options


def _stepping(fn):
    """True for a TimeFunction on a rolling buffer (a SteppingDimension)."""
    dims = getattr(fn, 'dimensions', ())
    return bool(getattr(fn, 'is_TimeFunction', False) and dims and
                dims[0].is_Stepping)


def _layout(fn):
    """What fixes a dense function's addressing in a runner: its halo, its
    allocated shape and its origin offset."""
    return (tuple(fn.halo), tuple(fn.shape_allocated),
            tuple(fn.origin_offset))


def _past_halo(schedule, fn):
    """The first access (or write) of ``fn`` by a dense item of
    ``schedule`` that reaches past ``fn``'s allocation, as text; None when
    every one stays inside."""
    ext = fn._allocated_space()

    def names(f):
        return [d.root.name if d.is_Derived else d.name
                for d in f.space_dimensions]
    for it in schedule.all_items:
        if not isinstance(it, LoweredEq) or it.target.grid is None:
            continue
        accs = [a for a in retrieve_functions(it.rhs)
                if a.function.name == fn.name]
        if it.target.name == fn.name:
            accs.append(it.lhs_access or it.target)
        for a in accs:
            if names(a.function) != names(it.target):
                continue
            offs = space_offsets_of(a, absolute='zero')
            for (lo, hi), (hl, _), oo, o, n in zip(
                    it.region, fn.halo, fn.origin_offset, offs, ext):
                if hl + lo - oo + o < 0 or hl + hi - oo + o > n:
                    return f"{a} over the region {it.region}"
    return None


#: The attributes of an Operator that ``_relaid`` builds anew for another
#: layout; every other attribute is the state of the applies, which the
#: Operator and its relaid copies share.
_LAYOUT_STATE = ('_schedule', '_reads', '_writes', '_sparse', '_symbols',
                 '_grid', '_save_spans', '_runner', '_bounded_cache',
                 '_halo_runner', 'halo_decline', '_layout_ops')


def _scalar(sym, v):
    """The runtime value ``v`` of the scalar symbol ``sym``: a complex
    rounded to its complex dtype where it has one, else a float, as the
    reference binds them. A Python complex, not a numpy scalar: torch
    promotes a real tensor times it to complex."""
    dt = getattr(sym, 'dtype', None)
    if dt is not None and np.issubdtype(np.dtype(dt), np.complexfloating):
        return complex(np.dtype(dt).type(complex(v)))
    return float(v)


class Operator:
    """Compile a list of expressions into a callable time loop.

    ``Operator(expressions, subs=model.spacing_map, name=..., opt=...)``;
    run with ``op.apply(dt=..., time_M=...)`` (also accepts ``time`` as an
    alias for ``time_M``, and per-function data overrides by name).

    ``opt``: 'noop' or 'advanced', also as ``(mode, {options})``, as in
    devito_tpu. 'advanced' runs CIRE (ir/cire.py; ``'cire'``, on by
    default, and ``configuration['cire']`` turn it off) and the hoisting of
    time-invariant subexpressions into prologue temporaries
    (ir/optimize.py; ``'hoist-invariants'``, on by default, with
    ``'hoist-trig-taps'`` True, False or 'auto', the default); 'noop'
    runs neither. ``'storage-dtype'`` ('bfloat16' or 'float16') stores
    the written TimeFunctions and compiler temporaries narrow, every
    function under ``'storage-dtype-scope': 'all'`` (``_storage_map``);
    ``'errctl': 'max'`` scans the written stepping functions for
    non-finite values every 100 steps and raises ExecutionError. Unknown
    options raise InvalidArgument.
    """

    def __init__(self, expressions, subs=None, name='Kernel', opt=None,
                 **kwargs):
        self._name = name
        self._opt, options = _parse_opt(opt)
        tic = _time.perf_counter()
        cire_on = (self._opt != 'noop' and bool(options.get('cire', True))
                   and bool(configuration['cire']))
        self._schedule = lower_expressions(expressions, subs=subs,
                                           cire=cire_on)
        if self._opt != 'noop' and options.get('hoist-invariants', True):
            # flop reduction: hoist time-invariant subexpressions into
            # prologue temporaries (reference: Lift + CIRE 'invariants',
            # passes/clusters/misc.py:13, aliases.py:34)
            from ..ir.optimize import hoist_invariants
            hoist_invariants(self._schedule, trig_taps=options.get(
                'hoist-trig-taps', 'auto'))
        self._collect()
        self._storage = self._storage_map(options)
        # the errctl scan's functions: the written stepping ones
        self._errctl = tuple(sorted(
            n for n, fn in self._writes.items() if _stepping(fn))) or None \
            if options.get('errctl') == 'max' else None
        self._runner = build_runner(self._schedule, self._storage,
                                    self._errctl)
        self._bounded_cache = {}
        self._autotuned = False
        self._estimate_flops()
        self._build_time = _time.perf_counter() - tic

    # -- pickling -----------------------------------------------------------
    # (reference: operator.py:121-143; the runner, its kernel plans with
    # their ctypes argument blocks, and the bounded runners are built again
    # from the pickled schedule, on the units already built)

    def __getstate__(self):
        state = dict(self.__dict__)
        for k in ('_runner', '_bounded_cache', '_stream_plan',
                  '_stream_first', '_stream_log', '_halo_runner',
                  '_layout_ops'):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._bounded_cache = {}
        self._runner = build_runner(self._schedule, self._storage,
                                    self._errctl)

    # -- lowering metadata -------------------------------------------------

    def _collect(self):
        reads = OrderedDict()
        writes = OrderedDict()
        sparse = OrderedDict()

        def _add_expr_fns(expr):
            for a in retrieve_functions(expr):
                fn = a.function
                reads[fn.name] = fn
                if fn.is_SparseFunction:
                    sparse[fn.name] = fn

        for it in self._schedule.all_items:
            if isinstance(it, LoweredEq):
                writes[it.target.name] = it.target
                reads[it.target.name] = it.target
                _add_expr_fns(it.rhs)
                if it.condition is not None:
                    _add_expr_fns(it.condition)
            elif isinstance(it, LoweredSparse):
                sparse[it.sparse.name] = it.sparse
                reads[it.sparse.name] = it.sparse
                _add_expr_fns(it.expr)
                if it.kind == 'interp':
                    writes[it.sparse.name] = it.sparse
                else:
                    writes[it.field.name] = it.field
                    reads[it.field.name] = it.field
        self._reads = reads
        self._writes = writes
        self._sparse = sparse

        # free scalar symbols (h_x, dt, Constants, ...)
        syms = OrderedDict()
        for it in self._schedule.all_items:
            if isinstance(it, LoweredEq):
                exprs = [it.rhs] + ([it.condition] if it.condition is not None
                                    else [])
            else:
                exprs = [it.expr]
            for e in exprs:
                for s in sympy.sympify(e).free_symbols:
                    if isinstance(s, (Dimension, AbstractFunction)):
                        continue
                    if s.name == '__loop_time__':
                        continue  # canonical time marker, bound to t
                    if isinstance(s, sympy.Symbol):
                        syms[s.name] = s
        # sparse geometry always needs spacings
        for fn in sparse.values():
            if fn.grid is not None:
                for d in fn.grid.dimensions:
                    syms[d.spacing.name] = d.spacing
        # symbolic (Constant) subsampling factors of conditional time
        # dims ride the params
        for fn in reads.values():
            dims = getattr(fn, 'dimensions', ())
            if dims and getattr(dims[0], 'is_Conditional', False):
                f = dims[0].factor
                if getattr(f, 'name', None) is not None:
                    syms[f.name] = f
        self._symbols = syms

        self._grid = None
        for fn in reads.values():
            if fn.grid is not None:
                self._grid = fn.grid
                break
        self._save_spans = self._find_save_spans()

    def _find_save_spans(self):
        """{name: (off_min, off_max)} of the time offsets at which each
        dense ``save``-kind TimeFunction is accessed: it sizes the device
        window under host streaming (reference: operator.py:254-283)."""
        spans = {}

        def _note(fn, off):
            lo, hi = spans.get(fn.name, (0, 0))
            spans[fn.name] = (min(lo, off), max(hi, off))

        for it in self._schedule.all_items:
            accs = []
            if isinstance(it, LoweredEq):
                accs = list(retrieve_functions(it.rhs))
                if it.condition is not None:
                    accs += list(retrieve_functions(it.condition))
                if it.lhs_access is not None:
                    accs.append(it.lhs_access)
            elif isinstance(it, LoweredSparse):
                accs = list(retrieve_functions(it.expr))
                if it.kind == 'inject' and it.field_time_kind == 'save':
                    _note(it.field, it.field_time_off or 0)
            for a in accs:
                fn = a.function
                if fn.is_SparseFunction:
                    continue
                tk, off = time_access_of(a)
                if tk == 'save':
                    _note(fn, off)
        return spans

    def _storage_map(self, options):
        """{function name: narrow torch dtype} under ``'storage-dtype'``
        (reference: operator.py:360-382, the storage part of
        ``_decide_layouts``): the TimeFunctions and compiler temporaries
        the operator writes or steps through, and under
        ``'storage-dtype-scope': 'all'`` every dense function it reads;
        sparse functions never. Empty without the option, or when it names
        a function's own dtype."""
        sdt = options.get('storage-dtype')
        if sdt is None:
            return {}
        want = storage_torch_dtype(sdt)
        scope = options.get('storage-dtype-scope', 'fields')
        out = {}
        for name, fn in self._reads.items():
            if fn.is_SparseFunction or not hasattr(fn, 'set_storage_dtype') \
                    or not np.issubdtype(fn.dtype, np.floating) or \
                    want == torch_dtype(fn.dtype):
                continue
            if scope == 'all' or (
                    (fn.is_TimeFunction or fn._compiler_temp) and
                    (name in self._writes or _stepping(fn))):
                out[name] = want
        return out

    def _estimate_flops(self):
        """Exact flops, points and bytes a step, in all and by section:
        one section per item of the schedule's body, labelled by its
        target's name or ``kind:sparse`` (``_sections``)."""
        per_step = points = traffic = static = 0
        sections = []
        for it in self._schedule.body:
            if isinstance(it, LoweredEq):
                shape = tuple(b - a for a, b in it.region)
                vol = int(np.prod(shape))
                c = estimate_cost(it.rhs) + (1 if it.increment else 0)
                per_step += c * vol
                points += vol
                nfuncs = len(retrieve_functions(it.rhs)) + 1
                tr = nfuncs * vol * it.target.dtype.itemsize
                traffic += tr
                sections.append((it.target.name, c * vol, vol, tr, shape))
            elif isinstance(it, LoweredSparse):
                npts = it.sparse.npoint or 0
                corners = it.sparse.interpolator.ncorners(
                    it.sparse.grid.dim if it.sparse.grid else 2)
                fl = (estimate_cost(it.expr) + 2) * npts * corners
                per_step += fl
                sections.append((f'{it.kind}:{it.sparse.name}', fl, npts, 0,
                                 (npts,)))
        for it in self._schedule.prologue + self._schedule.epilogue:
            if isinstance(it, LoweredEq):
                vol = int(np.prod([b - a for a, b in it.region]))
                static += estimate_cost(it.rhs) * vol
        self._sections = sections
        self._flops_per_step = per_step
        self._points_per_step = points
        self._traffic_per_step = traffic
        self._static_flops = static

    def _add_sections(self, summary, elapsed, nsteps):
        """One entry of ``summary`` a section (``section0``, ``section1``,
        ... in schedule order), with its exact flops, points and bytes over
        ``nsteps`` steps and its label in ``summary.labels``; each
        section's bytes also land in ``_section_traffic`` (reference:
        operator.py:1433-1481). An operator with no body item gets one
        ``section0`` of its totals.

        Times: after a measured apply (``_measured_secs``, from the
        ``dtpu_secN`` ranges of the trace, operator/trace_profile.py) each
        section gets its own measured device time, and the device time
        outside every section (``_measured_other``) is shared out by each
        section's flops + bytes; the times then sum to the measured busy
        time. Otherwise the loop's ``elapsed`` seconds are shared out by
        flops + bytes and sum to ``elapsed``."""
        secs = self._sections
        self._section_traffic = {f'section{i}': tr * nsteps
                                 for i, (_, _, _, tr, _) in enumerate(secs)}
        if not secs:
            traffic0 = self._traffic_per_step * nsteps
            self._section_traffic = {'section0': traffic0}
            summary.add('section0', elapsed,
                        flops=self._flops_per_step * nsteps,
                        points=self._points_per_step * nsteps,
                        traffic=traffic0)
            return
        meas = getattr(self, '_measured_secs', None)
        if meas is not None:
            other = getattr(self, '_measured_other', 0.0)
            weights = [(fl + tr) or 1 for _, fl, _, tr, _ in secs]
            total = sum(weights) or 1
            times = [meas.get(f'dtpu_sec{i}', 0.0) + other * w / total
                     for i, w in enumerate(weights)]
            busy = sum(meas.values()) + other
            cats = getattr(self, '_measured_cats', None) or {}
            log_perf(f"measured device busy {busy:.4f} s of {elapsed:.4f} s "
                     f"wall ({other * 1e3:.1f} ms outside sections, "
                     f"{getattr(self, '_measured_unattributed', 0)} device "
                     f"events unattributed); " + ", ".join(
                         f"{c}={v * 1e3:.1f} ms"
                         for c, v in cats.items() if v > 0))
        else:
            weights = [fl + tr for _, fl, _, tr, _ in secs]
            total = sum(weights)
            times = [elapsed * (w / total if total else 1 / len(weights))
                     for w in weights]
        for i, ((label, fl, pts, tr, shape), t) in enumerate(
                zip(secs, times)):
            name = f'section{i}'
            summary.add(name, t, flops=fl * nsteps, points=pts * nsteps,
                        traffic=tr * nsteps, itershapes=(shape,))
            summary.labels[name] = label

    # -- public introspection ---------------------------------------------

    @property
    def name(self):
        return self._name

    @property
    def schedule(self):
        return self._schedule

    @property
    def reads(self):
        return tuple(self._reads.values())

    @property
    def writes(self):
        return tuple(self._writes.values())

    @property
    def kernel_plans(self):
        """``(lowered eq, StencilPlan or None)`` per dense equation: None
        marks an equation the stencil kernel declined, which runs in the
        torch translator."""
        return list(self._runner.plans)

    @property
    def ccode(self):
        """The generated code of the Operator, in schedule order, as the
        reference Devito's ``op.ccode`` shows its C (devito_tpu's
        counterparts are ``jaxpr``/``hlo``): for each dense item, K1's
        design and why, then the CUDA translation unit nvcc builds for it
        (``StencilPlan.source``, with its point expression), once for the
        equations of a fused unit, at its first; for an item K1
        declines, the reason, and its equation, which the torch translator
        runs; for each sparse item its path: an interpolation separable
        (the contraction, operations/separable.py) or gathered, an
        injection scattered. Built on the host from the plans: it needs no
        nvcc and no card."""
        from ..kernels.stencil import decline_reason
        plans = {id(eq): p for eq, p in self._runner.plans}
        params = {s.name: float(v) for s, v in (
            self._grid.spacing_map.items() if self._grid is not None
            else ())}
        out = [f"// Operator `{self._name}` (direction="
               f"{'fwd' if self._schedule.direction > 0 else 'bwd'})"]
        for sec, items in [('prologue', self._schedule.prologue),
                           ('time loop', self._schedule.body),
                           ('epilogue', self._schedule.epilogue)]:
            for i, it in enumerate(items):
                out.append(f"// -- {sec}, item {i}: {it!r}")
                if isinstance(it, LoweredSparse):
                    out.append(f"//    sparse {it.kind}: "
                               + self._sparse_path(it, params))
                    continue
                plan = plans.get(id(it))
                if plan is None:
                    out.append(f"//    K1 declines it ({decline_reason(it)}"
                               f"); the torch translator runs "
                               f"{it.target.name} = {it.rhs}")
                    continue
                if plan.eq is not it:
                    out.append(f"//    K1, in the fused unit of "
                               f"{plan.eq.target.name} above")
                    continue
                out.append(f"//    K1, {plan.design} design "
                           f"({plan.design_reason})")
                out.append(plan.source.rstrip())
        return "\n".join(out) + "\n"

    def _sparse_path(self, it, params):
        """How ``apply`` runs the sparse item ``it`` with the sparse
        function's coordinates as they are."""
        if it.kind == 'inject':
            return "scatter-add of each point's corners (index_put_)"
        if configuration['separable']:
            from ..operations.separable import separable_geometry
            if separable_geometry(it.sparse, params) is not None:
                return ("separable: per-axis contractions of the band the "
                        "weights touch")
        return "gather of each point's corners, weighted sum"

    def __str__(self):
        lines = [f"Operator `{self._name}` "
                 f"(direction={'fwd' if self._schedule.direction > 0 else 'bwd'})"]
        for sec, items in [('prologue', self._schedule.prologue),
                           ('time loop', self._schedule.body),
                           ('epilogue', self._schedule.epilogue)]:
            if items:
                lines.append(f"  {sec}:")
                for it in items:
                    lines.append(f"    {it!r}")
        return "\n".join(lines)

    __repr__ = __str__

    # -- runtime arguments -------------------------------------------------

    def _default_time_bounds(self):
        """Default time_m/time_M following the reference's dspace-interval
        rule (devito operator.py:583): the loop-wide max positive/negative
        time offsets shrink the range given by the smallest time-sized
        array, so e.g. a forward acoustic operator with nt-row
        sources/receivers runs t in [1, nt-2]."""
        max_up, max_down = 0, 0

        def _cond_bound(td, size, off):
            """Static time_M bound implied by a subsampled save array —
            None when it cannot be known statically."""
            if getattr(td, 'condition', None) is not None:
                return None
            f = getattr(td, 'factor', None)
            if f is None or getattr(f, 'name', None) is not None:
                return None
            return int(f) * (size - off) - 1

        sized, cond_bounds = [], []
        for it in self._schedule.body:
            accs = []
            if isinstance(it, LoweredEq):
                accs = list(retrieve_functions(it.rhs))
                if it.lhs_access is not None:
                    accs.append(it.lhs_access)
            elif isinstance(it, LoweredSparse):
                accs = list(retrieve_functions(it.expr))
                if it.kind == 'interp' and it.sparse.is_SparseTimeFunction:
                    td = it.sparse.dimensions[0]
                    if getattr(td, 'is_Conditional', False) and \
                            td.factor is not None:
                        cb = _cond_bound(td, it.sparse.shape[0],
                                         it.target_time_off)
                        if cb is not None:
                            cond_bounds.append(cb)
                    else:
                        sized.append(it.sparse.shape[0] - 1)
                        max_up = max(max_up, it.target_time_off)
                if it.kind == 'inject' and it.field_time_kind is not None:
                    off = it.field_time_off or 0
                    max_up = max(max_up, off)
                    max_down = max(max_down, -off)
                    if it.field_time_kind == 'save':
                        sized.append(it.field.shape[0] - 1)
            for a in accs:
                fn = a.function
                tk, off = time_access_of(a)
                if tk is None or tk == 'abs':
                    continue
                if tk == 'cond':
                    size = fn._time_size or getattr(fn, 'save', None) or 1
                    cb = _cond_bound(fn.dimensions[0], size, off)
                    if cb is not None:
                        cond_bounds.append(cb)
                    continue
                max_up = max(max_up, off)
                max_down = max(max_down, -off)
                if tk == 'save':
                    sized.append(fn.shape[0] - 1)
        tm = max_down
        tM = None
        if sized:
            tM = min(sized) - max_up
        if cond_bounds:
            c = min(cond_bounds)
            tM = c if tM is None else min(tM, c)
        return tm, tM

    def arguments(self, **kwargs):
        """Assemble runtime arguments (dry-run of apply's preparation):
        ``(tensors by name, scalar params)``; a factorised sparse geometry
        rides the tensors as ``<name>_sep``."""
        return self._prepare(kwargs)[0:2]

    def _known_arguments(self):
        """Names ``apply`` accepts as overrides: functions, constants and
        dimension bounds."""
        known = set()
        for fn in self._reads.values():
            known.add(fn.name)
            for d in fn.dimensions:
                known.update((d.name, f'{d.name}_m', f'{d.name}_M'))
                if d.is_Stepping or d.is_Conditional:
                    r = d.parent
                    known.update((r.name, f'{r.name}_m', f'{r.name}_M'))
        known.update(self._symbols)
        known.update(('dt', 'time', 'time_m', 'time_M', 'autotune'))
        return known

    def _prepare(self, kwargs):
        kwargs = dict(kwargs)
        # function overrides by name: the override's tensor stands in for
        # the function's; its shape and dtype must match (another layout
        # runs on the Operator ``_relaid`` gives it)
        overrides = {}
        for k in list(kwargs):
            v = kwargs[k]
            if isinstance(v, AbstractFunction) or \
                    getattr(v, 'is_SparseFunction', False):
                overrides[k] = v.function
                kwargs.pop(k)
        for name, ofn in overrides.items():
            orig = self._reads.get(name)
            if orig is None or orig.is_SparseFunction:
                continue
            if tuple(ofn.shape) != tuple(orig.shape):
                raise InvalidArgument(
                    f"Override `{name}` has shape {tuple(ofn.shape)}; the "
                    f"Operator was built for {tuple(orig.shape)}")
            if np.dtype(ofn.dtype) != np.dtype(orig.dtype):
                raise InvalidArgument(
                    f"Override `{name}` has dtype {np.dtype(ofn.dtype)}; "
                    f"the Operator was built for {np.dtype(orig.dtype)}")

        # spatial bounds (reference: operator.py:632-669): x_m/x_M, and the
        # bare-dimension shorthand x=3 for x_M, which an explicit x_M wins
        # over
        sbounds = {}
        for d in (self._grid.dimensions if self._grid is not None else ()):
            lo = kwargs.pop(f'{d.name}_m', None)
            hi = kwargs.pop(f'{d.name}_M', None)
            bare = kwargs.pop(d.name, None)
            if hi is None:
                hi = bare
            if lo is not None or hi is not None:
                try:
                    sbounds[d.name] = (None if lo is None else int(lo),
                                       None if hi is None else int(hi))
                except (TypeError, ValueError):
                    raise InvalidArgument(
                        f"Bounds for dimension `{d.name}` must be integer "
                        f"scalars; got {d.name}_m={lo!r}, {d.name}_M={hi!r}")

        bound = {name: overrides.get(name, fn)
                 for name, fn in self._reads.items()}
        # host streaming: a streamed function's window is made below, once
        # the time bounds fix the first chunk
        plan = self._stream_plan = self._plan_streaming(bound)
        streamed = plan['fns'] if plan is not None else {}
        bufs = {}
        for name, fn in bound.items():
            if hasattr(fn, 'set_storage_dtype') and not fn.is_SparseFunction:
                fn.set_storage_dtype(self._storage.get(name, fn.dtype))
            if name not in streamed:
                bufs[name] = fn._device_array()
            if fn.is_SparseFunction:
                bufs[f"{name}_coords"] = fn._coords_device()
        devices = {b.device for b in bufs.values()}
        if len(devices) > 1:
            raise InvalidArgument(
                f"Operator `{self._name}`: functions live on several "
                f"devices {sorted(map(str, devices))}")

        # scalar params; a save function's row 0 is time 0 unless it streams
        params = {f'__save_base_{n}__': 0 for n in self._save_spans}
        if self._grid is not None:
            for s, v in self._grid.spacing_map.items():
                params[s.name] = float(v)
        for name, s in self._symbols.items():
            if isinstance(s, Constant):
                params[name] = _scalar(s, s.value)
        for name in self._symbols:
            if name in kwargs:
                v = kwargs.pop(name)
                if isinstance(v, Constant):
                    v = v.value
                params[name] = _scalar(self._symbols[name], v)
            elif name not in params:
                raise InvalidArgument(f"Missing runtime value for `{name}`")
        # dt / spacing overrides are accepted even when folded out of
        # the expressions
        known_scalars = {'dt'}
        if self._grid is not None:
            known_scalars.update(s.name for s in self._grid.spacing_map)
        for name in list(kwargs):
            if name in known_scalars and isinstance(
                    kwargs[name], (int, float, np.floating, np.integer)):
                params[name] = float(kwargs.pop(name))
        self._separable_setup(bound, bufs, params)

        # time bounds
        tm_d, tM_d = self._default_time_bounds()
        time_m = kwargs.pop('time_m', kwargs.pop('t_m', None))
        time_M = kwargs.pop('time_M', kwargs.pop('t_M', None))
        t_alias = kwargs.pop('time', kwargs.pop('t', None))
        if time_M is None and t_alias is not None:
            time_M = t_alias
        if time_m is None:
            time_m = tm_d
        if time_M is None:
            time_M = tM_d
        if self._schedule.body:
            if time_M is None:
                raise InvalidArgument(
                    "Cannot derive `time_M`; pass time_M= or time=")
            if int(time_m) < 0:
                raise InvalidArgument(f"time_m={time_m} must be >= 0")
            if tM_d is not None and int(time_M) > int(tM_d):
                raise InvalidArgument(
                    f"time_M={time_M} out of bounds: the smallest "
                    f"time-sized array allows at most {tM_d}")

        unknown = [k for k in kwargs if k != 'autotune']
        if unknown and not configuration['ignore-unknowns']:
            raise InvalidArgument(f"Unknown arguments {unknown}")
        time_m, time_M = int(time_m or 0), int(time_M or 0)
        if plan is not None:
            # each streamed function's window, holding the first chunk's
            # rows; its time of row 0 rides the params
            chunks = self._stream_chunks(plan, time_m, time_M)
            base = (chunks[0][0] if chunks else 0) + plan['span_lo']
            self._stream_first = []
            for name, fn in streamed.items():
                bufs[name] = fn._device_window(base, base + plan['rows'],
                                               split=self._stream_first)
                params[f'__save_base_{name}__'] = base
        return bufs, params, time_m, time_M, bound, sbounds

    def _plan_streaming(self, bound):
        """Decide host streaming of ``save=nt`` wavefields (reference:
        operator.py:804-846; the reference's buffering + Orchestrator,
        passes/clusters/buffering.py:27): when the save buffers exceed
        ``configuration['save-budget']`` bytes (or ``save-streaming`` is
        'on'), the time loop runs in chunks of K steps and only a window of
        ``K + span`` rows of each save buffer lives on the device. Returns
        None or ``{'fns', 'K', 'span_lo', 'rows'}``, devito_tpu's plan: the
        arithmetic is on the allocated shapes, which are devito_tpu's.
        Under 'on' a plan declined for a save function is logged with its
        reason."""
        mode = configuration['save-streaming']
        if mode == 'off' or not self._schedule.body or not self._save_spans:
            return None

        def decline(why):
            (warning if mode == 'on' else debug)(
                f"Operator `{self._name}`: save-streaming={mode!r} declined "
                f"({why}); the save buffers stay whole on the device")

        # re-running the prologue and epilogue once a chunk is sound only
        # for idempotent assignments
        for it in self._schedule.prologue + self._schedule.epilogue:
            if getattr(it, 'increment', False) or \
                    getattr(it, 'reduction', None):
                decline(f"{it!r} outside the time loop accumulates, and "
                        f"would run once a chunk")
                return None
        fns = {name: fn for name, fn in bound.items()
               if name in self._save_spans
               and getattr(fn, 'is_TimeFunction', False)
               and type(fn)._save is not None
               and fn._time_size and fn.shape[0] > 1}
        if not fns:
            decline("no save function of more than one row")
            return None
        budget = int(configuration['save-budget'])
        total = sum(int(np.prod(fn.shape_allocated)) * fn.dtype.itemsize
                    for fn in fns.values())
        if mode == 'auto' and total <= budget:
            return None
        row_bytes = sum(int(np.prod(fn.shape_allocated[1:])) *
                        fn.dtype.itemsize for fn in fns.values())
        span_lo = min(self._save_spans[n][0] for n in fns)
        span_hi = max(self._save_spans[n][1] for n in fns)
        span = span_hi - span_lo
        K = max(4, budget // max(row_bytes, 1) - span)
        nt = min(fn.shape[0] for fn in fns.values())
        if K >= nt and mode == 'auto':
            decline(f"K = {K} steps a chunk covers the {nt} rows")
            return None
        K = min(K, max(nt - 1, 4))
        return {'fns': fns, 'K': int(K), 'span_lo': int(span_lo),
                'rows': int(K + span)}

    def _stream_chunks(self, plan, time_m, time_M):
        """The chunks ``(first step, last step)`` of K steps covering
        ``[time_m, time_M]``, in the order they run: reversed when the
        schedule runs backward."""
        K = plan['K']
        chunks = [(c, min(c + K - 1, time_M))
                  for c in range(time_m, time_M + 1, K)]
        return chunks[::-1] if self._schedule.direction < 0 else chunks

    def estimate_memory(self, layers=False, **kwargs):
        """Bytes of device memory the operator's functions take
        (reference: operator.py:485-508): their allocated shapes in their
        compute dtypes, and each sparse function's coordinates. With
        ``layers=True``, ``{'device': ..., 'host': ...}`` under this
        configuration's streaming plan: a streamed function holds its
        window's rows on the device and its whole history on the host."""
        from ..parallel.halo import partitions, local_space
        plan = self._plan_streaming(dict(self._reads))
        grid = self._grid
        dist = grid.distributor if grid is not None else None
        parts = partitions(grid) if dist is not None else {}
        device = host = 0
        for fn in self._reads.values():
            shape = fn.shape_allocated
            nbytes = int(np.prod(shape)) * fn.dtype.itemsize
            if plan is not None and fn.name in plan['fns']:
                row = int(np.prod(shape[1:])) * fn.dtype.itemsize
                device += row * plan['rows']
                host += nbytes
                shape = (plan['rows'],) + tuple(shape[1:])
            else:
                device += nbytes
            if fn.is_SparseFunction:
                device += fn._coords_host.nbytes
            if dist is not None:
                # a sharded apply holds every shard's tensor besides the
                # whole one: a grid function's local layout a shard, a
                # replicated one's copy on every shard but the first
                if fn.is_SparseFunction or fn.grid is None:
                    device += nbytes * (dist.nprocs - 1)
                else:
                    lead = tuple(shape[:len(shape) - len(fn.halo)])
                    device += dist.nprocs * fn.dtype.itemsize * int(
                        np.prod(lead + local_space(fn, parts)))
        if layers:
            return {'device': device, 'host': host}
        return device

    def _separable_setup(self, bound, bufs, params):
        """Factorise the coordinates of every interpolated sparse function
        that allows it (operations/separable.py; reference:
        operator.py:744-770) and put its geometry on the device as
        ``bufs['<name>_sep']``: linear or sinc, at least 1024 points, a
        tensor product; under ``configuration['separable']``. Its host
        seconds land in ``separable_seconds``."""
        tic = _time.perf_counter()
        if self._sparse and configuration['separable']:
            from ..operations.separable import separable_geometry, to_device
            interp = {it.sparse.name for it in self._schedule.all_items
                      if isinstance(it, LoweredSparse) and
                      it.kind == 'interp'}
            for name in interp:
                fn = bound[name]
                if fn.is_SparseFunction:
                    sep = separable_geometry(fn, params)
                    if sep is not None:
                        bufs[f'{name}_sep'] = to_device(sep,
                                                        bufs[name].device)
        self.separable_seconds = _time.perf_counter() - tic

    def _bounded_runner(self, sbounds):
        """The runner over every dense item's region clamped to
        ``sbounds`` ({dim name: (lo or None, hi or None)}, inclusive), built
        once a set of bounds (reference: operator.py:1140-1181). A
        halo-extended region (CIRE's temporaries) keeps its extension
        around the clamp, so that its consumers' taps stay covered; an
        item clamped to nothing is dropped. Its kernel plans are new plans
        of the same units: the region reaches K1 as launch arguments."""
        key = tuple(sorted(sbounds.items()))
        if key in self._bounded_cache:
            return self._bounded_cache[key]

        def clamp(it):
            if not isinstance(it, LoweredEq) or it.target.grid is None:
                return it
            region = []
            for d, (a, b) in zip(it.target.space_dimensions, it.region):
                dn = d.root.name if d.is_Derived else d.name
                lo, hi = sbounds.get(dn, (None, None))
                ext = max(0, -a)
                na = a if lo is None else max(a, lo - ext)
                nb = b if hi is None else min(b, hi + 1 + ext)
                if nb <= na:
                    return None
                region.append((na, nb))
            new = _copy.copy(it)
            new.region = tuple(region)
            return new

        parts = [[c for c in map(clamp, items) if c is not None]
                 for items in (self._schedule.prologue, self._schedule.body,
                               self._schedule.epilogue)]
        # a kept body item keeps its section's tag
        sections = [f'dtpu_sec{i}' for i, it in enumerate(self._schedule.body)
                    if clamp(it) is not None]
        runner = build_runner(Schedule(*parts, self._schedule.direction),
                              self._storage, self._errctl, sections)
        self._bounded_cache[key] = runner
        return runner

    # -- execution -----------------------------------------------------------

    def _relaid(self, kwargs):
        """The Operator that runs ``kwargs``' function overrides: this one,
        or, where an override has the shape and dtype of the function it
        stands in for but another layout (``_layout``: its halo, as
        ``solver.jacobian(dm)`` binds a ``dm`` of space order 1 to Born's of
        space order 0), a copy whose schedule accesses the overrides'
        functions (ir/lowering.py ``rebind``), with a runner planned for
        their layouts. It is built once a signature of the layouts, kept in
        ``_layout_ops``, and logged; ``relayouts`` counts the builds. The
        Operator's own functions keep its own runner and plans. Its K1
        plans are made as any plan is: a layout may change a plan's design,
        and one K1 declines runs in the torch translator with its reason."""
        relaid = {}
        for name, v in kwargs.items():
            orig = self._reads.get(name)
            if orig is None or orig.is_SparseFunction or not (
                    isinstance(v, AbstractFunction)):
                continue
            fn = v.function
            if tuple(fn.shape) == tuple(orig.shape) and \
                    _layout(fn) != _layout(orig):
                relaid[name] = fn
        if not relaid:
            return self
        key = tuple(sorted((n, _layout(f)) for n, f in relaid.items()))
        cache = self.__dict__.setdefault('_layout_ops', {})
        op = cache.get(key)
        if op is None:
            sched = rebind(self._schedule, relaid)
            for n, f in sorted(relaid.items()):
                why = _past_halo(sched, f)
                if why is not None:
                    raise InvalidArgument(
                        f"Override `{n}` has halo {tuple(f.halo)}: "
                        f"Operator `{self._name}` reaches past it ({why})")
            op = _copy.copy(self)
            for k in ('_halo_runner', 'halo_decline'):
                op.__dict__.pop(k, None)
            op._layout_ops = {}
            op._schedule = sched
            op._collect()
            op._runner = build_runner(op._schedule, self._storage,
                                      self._errctl)
            op._bounded_cache = {}
            cache[key] = op
            self.relayouts = getattr(self, 'relayouts', 0) + 1
            planned = [p for _, p in op._runner.plans if p is not None]
            log_perf(f"Operator `{self._name}`: the overrides "
                     f"{sorted(relaid)} have another layout ("
                     + ", ".join(f"{n} halo {tuple(f.halo)} against "
                                 f"{tuple(self._reads[n].halo)}"
                                 for n, f in sorted(relaid.items()))
                     + f"); a runner for it, {len(planned)} K1 plans")
        return op

    def _halo_runner_for(self):
        """The ShardedRunner of this Operator on a distributed Grid, built
        at the first call, or None: no distributed Grid, or a schedule
        ``explicit_halo_eligible`` rejects under ``halo='auto'``, which
        then runs gathered (the reason logged, kept in ``halo_decline``);
        under ``halo='explicit'`` such a schedule raises InvalidArgument
        (devito_tpu: operator.py:1221-1240)."""
        if getattr(self, '_halo_runner', '?') != '?':
            return self._halo_runner
        runner = None
        self.halo_decline = None
        grid = self._grid
        if grid is not None and grid.distributor is not None:
            from ..parallel.halo import explicit_halo_reason, ShardedRunner
            why = explicit_halo_reason(self)
            if why is None:
                runner = ShardedRunner(self)
                log_perf(f"Operator `{self._name}`: explicit halo exchange "
                         f"over the mesh {grid.distributor.topology}")
            elif configuration['halo'] == 'explicit':
                raise InvalidArgument(
                    f"halo='explicit' requested but the schedule of "
                    f"`{self._name}` is not eligible for the explicit halo "
                    f"path: {why}")
            else:
                self.halo_decline = why
                log_perf(f"Operator `{self._name}`: runs gathered on the "
                         f"whole tensors ({why})")
        self._halo_runner = runner
        return runner


    def apply(self, **kwargs):
        """Run the time loop; returns a PerformanceSummary. On CUDA the
        time is measured with CUDA events around the loop.

        ``autotune`` (or ``configuration['autotuning']``) is accepted; this
        package has no tuner, so it logs that once and runs untuned, as
        devito_tpu's Pallas backend does (operator.py:970-989). Under
        errctl='max' a failed stability check raises ExecutionError once
        the tensors are adopted.

        Under a streaming plan (``_plan_streaming``) the loop runs in
        chunks (``_apply_streamed``). Under ``profiling='measured'`` or
        with ``profile-dir`` set, the loop runs under torch.profiler with
        each body item in its ``dtpu_secN`` range, its Chrome trace goes
        into ``profile-dir`` (a temporary directory when unset), and
        'measured' gives each section its device time from it
        (operator/trace_profile.py); with no device event in the trace (the
        CPU) it warns and keeps the shares of the cost model. The log line
        gives the share of the device's memory roofline (arch.py).

        While a profiler records, the call is the span ``dtpu::apply``
        (utils/tools.py ``span``), with three children:
        ``dtpu::apply.prepare`` (the arguments and the choice of runner),
        ``dtpu::apply.loop`` (the runner's call, each chunk's under a
        streaming plan) and ``dtpu::apply.finish`` (the written tensors
        adopted, the sections, the summary and the log lines)."""
        with span('dtpu::apply'):
            return self._apply(kwargs)

    def _apply(self, kwargs):
        from ..arch import get_platform, roofline_fraction
        op = self._relaid(kwargs)
        if op is not self:
            # the applies' state is shared both ways
            op.__dict__.update({k: v for k, v in self.__dict__.items()
                                if k not in _LAYOUT_STATE})
            try:
                return op._apply(kwargs)
            finally:
                self.__dict__.update({k: v for k, v in op.__dict__.items()
                                      if k not in _LAYOUT_STATE})
        with span('dtpu::apply.prepare'):
            autotune = kwargs.pop('autotune', None)
            if autotune is None and configuration['autotuning'] != 'off':
                autotune = configuration['autotuning']
            if autotune and not self._autotuned:
                log_perf(f"Operator `{self._name}`: autotune={autotune!r} "
                         f"asked for; devito_tpu_torch has no tuner, "
                         f"running untuned")
                self._autotuned = True
            bufs, params, time_m, time_M, bound, sbounds = \
                self._prepare(kwargs)
            runner = self._bounded_runner(sbounds) if sbounds else \
                self._runner
            hr = self._halo_runner_for()
            if hr is not None and sbounds:
                log_perf(f"Operator `{self._name}`: spatial bounds "
                         f"{sbounds} run gathered on the whole tensors")
                hr = None
            if hr is None and self._grid is not None and \
                    self._grid.distributor is not None:
                self.gathered_applies = \
                    getattr(self, 'gathered_applies', 0) + 1
            device = next(iter(bufs.values())).device if bufs else \
                torch.device('cpu')
            on_cuda = device.type == 'cuda'
            nsteps = max(time_M - time_m + 1, 0) if self._schedule.body \
                else 0
            flops = self._flops_per_step * nsteps + self._static_flops
            points = self._points_per_step * nsteps
            traffic = self._traffic_per_step * nsteps
            summary = PerformanceSummary(
                device=torch.cuda.get_device_name(device) if on_cuda
                else 'cpu')
            plat = summary.platform = get_platform(device)
            plan = self._stream_plan
            if plan is None:
                trace_dir = configuration['profile-dir']
                measured = configuration['profiling'] == 'measured'
                tmp = None
                if measured and not trace_dir:
                    tmp = trace_dir = tempfile.mkdtemp(
                        prefix='dtpu_torch_prof_')
                self._measured_cats = None
                self._measured_secs, self._measured_other = None, 0.0
                self._measured_unattributed = 0
                loop_bufs, sync = bufs, None
                if hr is not None:
                    # the shards, cut from the whole tensors; their
                    # interiors are written back below
                    loop_bufs, runner = hr.prepare_buffers(bufs), hr.runner
                    sync = hr.synchronize
                    copies0, bytes0 = hr.exchange['copies'], \
                        hr.exchange['bytes']

        def roof(nbytes, seconds, fmt):
            r = roofline_fraction(plat, nbytes, seconds)
            return fmt.format(100 * r, plat.name) if r is not None else ''

        if plan is not None:
            elapsed = self._apply_streamed(plan, bufs, params, time_m,
                                           time_M, bound, runner, hr)
            with span('dtpu::apply.finish'):
                summary.add('section0', elapsed, flops=flops, points=points,
                            traffic=traffic)
                summary.add_glb(elapsed, flops=flops, points=points,
                                traffic=traffic)
                e = summary['section0']
                log_perf(f"Operator `{self._name}` ran in {elapsed:.4f} s "
                         f"on {summary.device} (host-streamed save) "
                         f"[{e.gpointss:.2f} GPts/s"
                         + roof(traffic, elapsed,
                                ", {:.0f}% of {} HBM roofline")
                         + "]")
            return summary

        if trace_dir:
            from torch.profiler import profile, ProfilerActivity
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_cuda else [])
            with profile(activities=acts) as prof:
                elapsed, halted = self._timed_loop(runner, loop_bufs, params,
                                                   time_m, time_M, on_cuda,
                                                   sync=sync)
        else:
            elapsed, halted = self._timed_loop(runner, loop_bufs, params,
                                               time_m, time_M, on_cuda,
                                               sync=sync)
        with span('dtpu::apply.finish'):
            if trace_dir:
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    trace_dir,
                    f'{self._name}.{_time.time_ns()}.pt.trace.json'))
                if measured:
                    self._read_trace(trace_dir)
                if tmp:
                    shutil.rmtree(tmp, ignore_errors=True)
            if hr is not None:
                for name in self._writes:
                    hr.restore(name, [b[name] for b in loop_bufs],
                               bufs[name])
                self.last_exchange = {
                    'copies': hr.exchange['copies'] - copies0,
                    'bytes': hr.exchange['bytes'] - bytes0}
                del loop_bufs
                log_perf(f"Operator `{self._name}`: sharded over the mesh "
                         f"{self._grid.distributor.topology} "
                         f"({len(hr.shards)} shards on "
                         f"{sorted({str(sh.device) for sh in hr.shards})});"
                         f" the exchange moved {self.last_exchange['bytes']}"
                         f" bytes in {self.last_exchange['copies']} copies")

            # the tensors were updated in place: the device copy is now the
            # authoritative one
            for name in self._writes:
                bound[name]._set_device_array(bufs[name])
            if halted is not None:
                raise ExecutionError(
                    f"Stability check failed at step {halted}: non-finite "
                    f"values in {list(self._errctl)} (errctl='max')")
            if configuration['develop-mode']:
                for name in self._writes:
                    if not bool(torch.isfinite(bufs[name]).all()):
                        raise ExecutionError(
                            f"Detected nan/inf in `{name}` output")

            self._add_sections(summary, elapsed, nsteps)
            summary.add_glb(elapsed, flops=flops, points=points,
                            traffic=traffic)
            g = summary.globals['fdlike']
            log_perf(f"Operator `{self._name}` ran in {elapsed:.4f} s on "
                     f"{summary.device} [{g.gpointss:.2f} GPts/s, "
                     f"{g.gflopss:.2f} GFlops/s"
                     + roof(traffic, elapsed,
                            ", {:.0f}% of {} HBM roofline")
                     + "]")
            for name, e in summary.items():
                log_perf(f"  {name} ({summary.labels.get(name, '')}): "
                         f"{e.time:.4f} s, {e.gflopss:.2f} GFlops/s, "
                         f"{e.gpointss:.2f} GPts/s"
                         + roof(self._section_traffic.get(name, 0), e.time,
                                ", {:.0f}% roofline"))
        return summary

    @staticmethod
    def _timed_loop(runner, bufs, params, time_m, time_M, on_cuda,
                    sync=None):
        """``runner``'s loop over ``[time_m, time_M]``: (its seconds, CUDA
        events around it on the card, the host clock elsewhere; the step
        whose stability check failed, or None). ``sync``, if given, runs
        before the closing stamp: a sharded run's other devices finish.
        The runner's call alone is the span ``dtpu::apply.loop``."""
        a = _stamp(on_cuda)
        with span('dtpu::apply.loop'):
            halted = runner(bufs, params, time_m, time_M)
        if sync is not None:
            sync()
        b = _stamp(on_cuda)
        if on_cuda:
            b.synchronize()
        return _seconds(a, b), halted

    def _read_trace(self, trace_dir):
        """A measured apply's sections from its trace (``_measured_secs``,
        ``_measured_other``, ``_measured_unattributed``, ``_measured_cats``;
        reference: operator.py:1337-1352); with no device event, a
        warning, and the cost model's shares stay."""
        from .trace_profile import attribute, categorize_ops, \
            device_op_durations
        res = attribute(trace_dir)
        if res is None:
            warning("profiling='measured': no device event in the trace "
                    "(CPU run?); falling back to cost-model apportioning")
            return
        self._measured_secs = res['sections'] or None
        self._measured_other = res['other']
        self._measured_unattributed = res['unattributed']
        self._measured_cats = categorize_ops(device_op_durations(trace_dir))

    def _apply_streamed(self, plan, bufs, params, time_m, time_M, bound,
                        runner, hr=None):
        """The chunked time loop of a streaming plan (reference:
        operator.py:848-914): K steps a chunk, in reverse chunk order when
        the schedule runs backward, each chunk's windows filled with its
        rows before it runs and, for the written functions, written back
        to the host after; the same runner and kernel units every chunk,
        whose prologue and epilogue run each chunk; the other tensors,
        rolling buffers included, carry from chunk to chunk. A chunk whose
        stability check fails ends the loop, and ExecutionError is raised
        once the tensors are adopted. Returns the seconds of the chunks'
        loops (CUDA events on the card); ``_stream_log`` gets each chunk's
        steps and the ms and bytes of its host-to-staging, staging-to-
        device, compute, device-to-staging and staging-to-host parts
        ('h2s', 's2d', 'compute', 'd2s', 's2h'; 'pin' where it allocated
        the staging tensor).

        With ``hr`` (a ShardedRunner; devito_tpu: operator.py:849-913)
        the chunks run sharded: the shards are cut once, each chunk's
        windows are cut into them afresh and written back from them before
        they go to the host, and the other shards carry from chunk to
        chunk until they are written back at the end."""
        names = plan['fns']
        on_cuda = next(iter(names.values())).device.type == 'cuda'
        spans = []
        halted = None
        sbufs = hr.prepare_buffers(bufs) if hr is not None else None
        try:
            for i, (c0, c1) in enumerate(self._stream_chunks(
                    plan, time_m, time_M)):
                base = c0 + plan['span_lo']
                split = self._stream_first if i == 0 else []
                params2 = dict(params)
                for name, fn in names.items():
                    if i:
                        bufs[name] = fn._device_window(
                            base, base + plan['rows'], out=bufs[name],
                            split=split)
                        if hr is not None:
                            for b, t in zip(sbufs,
                                            hr.convert(name, bufs[name])):
                                b[name] = t
                    params2[f'__save_base_{name}__'] = base
                a = _stamp(on_cuda)
                with span('dtpu::apply.loop'):
                    halted = runner(bufs, params2, c0, c1) if hr is None \
                        else hr.runner(sbufs, params2, c0, c1)
                if hr is not None:
                    hr.synchronize()
                split.append(('compute', a, _stamp(on_cuda), 0))
                for name, fn in names.items():
                    if name in self._writes:
                        if hr is not None:
                            hr.restore(name, [b[name] for b in sbufs],
                                       bufs[name])
                        fn._absorb_window(bufs[name], base, split=split)
                spans.append(((c0, c1), split))
                if halted is not None:
                    break
            if on_cuda:
                torch.cuda.synchronize(next(iter(bufs.values())).device)
        finally:
            for fn in names.values():
                fn._release_staging()
            self._stream_first = None
        self._stream_log = []
        for steps, split in spans:
            row = {'steps': steps}
            for phase, a, b, nbytes in split:
                ms, nb = row.get(phase, (0.0, 0))
                row[phase] = (ms + _seconds(a, b) * 1e3, nb + nbytes)
            self._stream_log.append(row)
        for name in self._writes:
            if name not in names:
                if hr is not None:
                    hr.restore(name, [b[name] for b in sbufs], bufs[name])
                bound[name]._set_device_array(bufs[name])
        if halted is not None:
            raise ExecutionError(
                f"Stability check failed at step {halted}: non-finite "
                f"values in {list(self._errctl)} (errctl='max')")
        elapsed = sum(r['compute'][0] for r in self._stream_log) / 1e3
        tot = {p: sum(r[p][0] for r in self._stream_log if p in r)
               for p in ('pin', 'h2s', 's2d', 'compute', 'd2s', 's2h')}
        log_perf(f"Operator `{self._name}`: {len(self._stream_log)} chunks "
                 f"of {plan['K']} steps, windows of {plan['rows']} rows of "
                 f"{sorted(names)}; ms " + ", ".join(
                     f"{p} {v:.1f}" for p, v in tot.items()))
        return elapsed

    def __call__(self, **kwargs):
        return self.apply(**kwargs)
