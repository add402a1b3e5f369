"""K1: the dense-stencil update, as a CUDA C++ kernel for Hopper.

Ports ``experiments/pallas_backend.py`` (``plan_for``/``_plan_for``,
``_TileCtxV2``, ``execute_plan``). ``plan_for`` decides at build time,
from the equation's shape alone, whether a lowered dense equation can run
in the kernel; ``stencil_update`` runs one update of the target's time row
in place; ``stencil_update_reference`` is its plain PyTorch version.

The kernel has two designs, both a hand-written template plus one point
expression printed from the equation's right-hand side by
``compiler.translate.cuda_expr``. ``plan_for`` picks one from the
equation's shape alone, records it on the plan (``plan.design`` and
``plan.design_reason``), logs it and counts it in ``designs``:

- ``'stream'`` (``csrc/stencil_stream.cuh``): a 3-D equation whose staged
  groups -- those read off their centre, u[t] in the acoustic update --
  are read along the axes only (a star), at most ``MAX_STAGED`` of them
  and none beyond ``MAX_RADIUS`` per axis, the reach the card tests
  check; more than ``FEW_STAGED`` of them only when the widest reaches
  ``WIDE_RADIUS``. Each CTA streams a (TY, TZ) tile along x: the staged
  planes, each group's at its own tap shape, and with them the other
  groups' tiles, arrive by TMA into small rings in shared memory, and the
  x taps live in per-thread register queues. ``stream_tile`` picks the
  first tile of ``STREAM_TILES`` that lets two or more CTAs share an SM.
- ``'point'`` (``csrc/stencil.cuh``): one thread per point, every tap
  through the read-only cache. Every other equation: 2-D regions, taps
  off the axes (cross derivatives), wider stars, windows the tile does
  not fit, halo-extended regions -- CIRE's temporaries and the hoisted
  prologue items, computed into the halo -- whose first point the
  launch's row pointers move back by the overhang (``_origin``), and
  narrow storage: rows stored as bfloat16 or float16 (the
  ``storage-dtype`` option), widened at each load and rounded at the
  store, whose 2-byte elements the streaming design's TMA boxes do not
  take. Every tap, and the write, must stay inside its function's
  allocation.

``plan_run`` plans a run of consecutive equations of a time loop's body:
``plan_for``'s plan for each, except that consecutive equations that
would each take the point design, write one region every step and read
no row another of them writes share one point unit (``_fusible``), when
the access groups they share make its union smaller than theirs apart.
The unit evaluates every target at each point, in one launch, and reads
each shared group once; each target's expression is printed as its own
unit prints it, so each value is its own launch's, bit for bit.

On a CUDA tensor the chosen design launches or raises; nothing falls back
to the other design or to the plain version. At its first CUDA launch the
generated source is written to ``devito_tpu_torch/_build/`` under the hash
of its text, the ``csrc/`` headers it includes and the nvcc flags,
compiled with nvcc into a shared library and loaded with ctypes
(``kernels/_nvcc.py``). Parameters (dt, spacings, Constants), row
pointers, strides and region extents are runtime arguments, so no value
and no grid size is baked into a build: ``apply(dt=...)`` never rebuilds,
and offsets follow each function's actual halo at every launch.

K2, the self-test (``validate_backend``, kernel ``csrc/selftest.cu``),
ports ``experiments/pallas_backend.py`` ``validate_backend``: before the
first K1 launch of a process on a device it runs a miniature kernel of
the same data movement and raises on a wrong answer.
"""

import ctypes
import re
from collections import OrderedDict

import numpy as np
import sympy
import torch

from . import _nvcc
from ._nvcc import build_seconds, build_log, check_launch  # noqa: F401
from ..compiler.translate import translate, cuda_expr
from ..exceptions import CompilationError, InvalidOperator
from ..ir.lowering import time_access_of, space_offsets_of
from ..logger import debug
from ..types.basic import AbstractFunction, retrieve_functions
from ..types.dense import torch_dtype, widen
from ..types.dimension import Dimension
from ..utils import span

__all__ = ['StencilPlan', 'plan_for', 'plan_run', 'decline_reason',
           'build',
           'point_flops', 'stream_tile', 'stream_occupancy',
           'stencil_update', 'stencil_update_reference', 'validate_backend',
           'selftest_window_sum', 'selftest_window_sum_reference']

#: Kernel launches since import (or since the caller last reset it).
launches = 0
#: The same launches by design.
launches_by_design = {'point': 0, 'stream': 0}
#: Plans made, by the design ``plan_for`` chose.
designs = {'point': 0, 'stream': 0}
#: Equations ``plan_for`` declined since import.
declines = 0
#: Fused units ``plan_run`` made since import: the units of more than one
#: equation, and the equations in them.
fused = {'units': 0, 'equations': 0}
#: Self-test kernel (K2) launches.
selftest_launches = 0
#: Self-tests run (``validate_backend``), passed or not.
selftests = 0
#: Devices whose self-test passed in this process; a device taken out
#: is self-tested again before its next kernel launch.
validated = set()

_CTYPE = {np.dtype(np.float32): 'float', np.dtype(np.float64): 'double'}
#: The C++ type of each storage dtype a row may have.
_STYPE = {torch.float32: 'float', torch.float64: 'double',
          torch.bfloat16: '__nv_bfloat16', torch.float16: '__half'}


class StencilPlan:
    """What the kernel needs to know about one dense equation, or about
    the equations of a fused unit.

    ``eqs``: the equations the unit writes, in schedule order (one, unless
    ``plan_run`` fused them); ``eq`` is the first, ``nt`` their number.
    ``groups``: one entry per (function, time access) read by the
    right-hand sides, in first-read order: ``{'fn', 'tk', 'toff', 'key'}``.
    ``design``: ``'stream'`` or ``'point'``, with ``design_reason``.
    ``staged`` and ``centre``: the indices into ``groups`` of the groups
    read off their centre and of those read at offset 0 only;
    ``group_radii``: each staged group's own reach per axis (x, y, z), in
    ``staged`` order; ``radii``: their union; ``tile``: ``stream_tile``'s
    choice (stream design only). ``source``: the generated CUDA
    translation unit; ``key`` hashes it with every ``csrc/`` header it
    includes.
    ``launches``: this plan's kernel launches (``stencil_update``).
    ``storage``: the torch dtype of each row, the targets' first, then
    each group's: the compute dtype, or a narrow one (``narrow``).
    ``origins``: each row's element offset, per axis, of the region's
    first point, in the same order. ``reach``: each group's largest
    offset per axis, in ``groups`` order; ``chunk_rows``: the rows of a
    chunk of the point design's 3-D launch (``_chunk_rows``; 0: one).
    """

    def __init__(self, eq, groups, param_names, design, reason, staged,
                 centre, group_radii, tile, storage, space=None, eqs=None,
                 reach=None):
        self.eqs = list(eqs or [eq])
        self.eq = eq = self.eqs[0]
        self.nt = len(self.eqs)
        # each row's halo'd extent per space axis: the function's own, or
        # a shard's local layout (parallel/halo.py ShardedRunner.local_space)
        self.space = space or _own_space
        self.storage = storage
        self.narrow = any(s in (torch.bfloat16, torch.float16)
                          for s in storage)
        self.groups = groups
        self.param_names = param_names
        self.design = design
        self.design_reason = reason
        self.staged = staged
        self.centre = centre
        self.group_radii = group_radii
        self.reach = reach
        self.radii = tuple(max(r[d] for r in group_radii) for d in range(3)) \
            if design == 'stream' else None
        self.tile = tile
        self.launches = 0
        self.dtype = np.dtype(eq.target.dtype)
        self.ndim = len(eq.region)
        self.extents = tuple(b - a for a, b in eq.region)
        self.origins = [_origin(eq, e.target) for e in self.eqs] + [
            _origin(eq, g['fn']) for g in groups]
        self.source = (_generate_stream(self) if design == 'stream'
                       else _generate(self.eqs, groups, param_names,
                                      storage))
        self.key = _nvcc.unit_key(self.source)
        n = len(groups) + self.nt
        self._ptrs = (ctypes.c_void_p * n)()
        self._strides = (ctypes.c_longlong * (2 * n))()
        self.chunk_rows = _chunk_rows(self)
        # the extents, then the rows of a chunk of the point design's
        # launch (csrc/stencil.cuh ``launch``), set at each launch
        self._n = (ctypes.c_int * 4)(*(self.extents + (1,) * (3 - self.ndim)),
                                     0)
        self._params = (ctypes.c_double * max(len(param_names), 1))()
        if design == 'stream':
            # rows in the launch's order: target, staged, centre
            self._rows = [0] + [1 + k for k in staged + centre]
            fns = [eq.target] + [g['fn'] for g in groups]
            self._dims = (ctypes.c_longlong * (3 * n))(*[
                d for r in self._rows for d in self.space(fns[r])])
            self._org = (ctypes.c_int * (3 * n))(*[
                o for r in self._rows for o in self.origins[r]])


def _access_key(e):
    """The access group of a function access: (name, time kind, time
    offset)."""
    tk, toff = time_access_of(e)
    return (e.function.name, tk, str(toff))


def _origin(eq, fn):
    return tuple(hl + a - oo for (a, _), (hl, _), oo
                 in zip(eq.region, fn.halo, fn.origin_offset))


def _own_space(fn):
    return fn._allocated_space()


def plan_for(eq, storage=None, _design=None, _tile=None, space=None):
    """A StencilPlan for a lowered dense equation, or None (logged and
    counted in ``declines``) when the kernel cannot take it. The decision,
    and the choice of design, rest on the equation's shape and on
    ``storage`` ({function name: torch dtype} of the functions stored
    narrow; the rest are stored in their compute dtype), as the TPU
    backend's rested on the shape and dtypes. ``_design`` ('point') and
    ``_tile`` (a (TY, TZ, PY, STAGES, TX) tuple for ``stream_tile``)
    override the choice: chip_smoke.py's comparisons and tile sweep use
    them, and so do the tests that hold one design against the other
    (tests/test_torch_stencil.py, test_torch_stencil_stream.py,
    test_torch_k1_units.py, test_torch_inverse.py, test_torch_probes.py
    and test_torch_chip_smoke.py); the program does not. ``space`` (a
    function's halo'd extent per space axis, default its
    ``_allocated_space``) plans for other rows: a shard's
    (parallel/halo.py)."""
    global declines
    plan, reason = _plan_or_reason(eq, storage, _design, _tile, space)
    if plan is None:
        declines += 1
        debug(f"stencil kernel: {eq} runs in the torch translator ({reason})")
        return None
    designs[plan.design] += 1
    debug(f"stencil kernel: {eq} runs in the {plan.design} design "
          f"({reason})")
    return plan


def decline_reason(eq):
    """Why ``plan_for`` declines ``eq``, or None when it plans it; counts
    and logs nothing."""
    plan, reason = _plan_or_reason(eq)
    return None if plan is not None else reason


#: The most access groups a fused unit reads: its arguments hold a pointer
#: and two strides a group, and each thread an offset a group. The widest
#: union timed on the H100, elastic's six stresses (15 groups, 80
#: registers, no spill), ran 30 % faster than its equations apart.
MAX_FUSED_GROUPS = 16
#: The most operations a byte of its own rows an equation may make to join
#: a fused unit: one that makes more is bound by its arithmetic, not by
#: its bytes, and the union's registers only cost it occupancy. On the
#: H100 at 512^3 the members that gained fused made 0.3-1.9 (elastic's
#: 1.2, TTI's 0.9-1.7, the CIRE temporaries of the self-adjoint and
#: visco-acoustic solvers'), and the visco-elastic shear stresses, 4.2
#: with 14 divisions each, ran 17 % slower fused than apart (PERF.md §6).
FUSE_FLOPS_PER_BYTE = 3
#: The H100's L2 cache; a point unit whose x taps keep more than
#: LIVE_SHARE of it live runs in chunks of POINT_CHUNK_ROWS rows
#: (``_chunk_rows``).
L2_BYTES, LIVE_SHARE, POINT_CHUNK_ROWS = 50 * 2 ** 20, 2 / 3, 64


def plan_run(eqs, storage=None):
    """One plan for each equation of ``eqs``, consecutive dense items of a
    time loop's body with nothing between them: ``plan_for``'s (counted and
    logged as it counts and logs them), except that each maximal run of
    consecutive equations that may share a launch (``_joins``) shares one
    point unit of them all. The runner launches such a unit once, in place
    of its equations' launches; ``fused`` counts it and its equations."""
    plans = [plan_for(eq, storage=storage) for eq in eqs]
    out, run = list(plans), []

    def close():
        if len(run) > 1:
            unit = _fuse([plans[k] for k in run])
            if unit is not None:
                for k in run:
                    out[k] = unit
        run.clear()

    for k, plan in enumerate(plans):
        if run and _joins([plans[j] for j in run], plan):
            run.append(k)
            continue
        close()
        if _fusible(plan):
            run.append(k)
    close()
    return out


def _fusible(plan):
    """True when ``plan`` may join a fused unit: the point design, on the
    function's own rows, for an equation that writes every step and makes
    at most ``FUSE_FLOPS_PER_BYTE`` operations a byte of its rows."""
    return plan is not None and plan.design == 'point' and \
        plan.space is _own_space and plan.eq.time_kind != 'cond' and \
        point_flops(plan) <= FUSE_FLOPS_PER_BYTE * plan.dtype.itemsize * (
            len(plan.groups) + 1)


def _joins(run, plan):
    """True when ``plan``'s equation may join the fused unit of the plans
    ``run``: it is ``_fusible``, with their region, compute dtype and
    target storage; it reads no row one of them writes, and they read none
    it writes; it shares an access group with them, and their union stays
    within ``MAX_FUSED_GROUPS``."""
    if not _fusible(plan):
        return False
    eq, first = plan.eq, run[0]
    if eq.region != first.eq.region or plan.dtype != first.dtype or \
            plan.storage[0] != first.storage[0]:
        return False
    for p in run:
        if _overlaps(p, plan) or _overlaps(plan, p):
            return False
    keys = {g['key'] for p in run for g in p.groups}
    new = [g for g in plan.groups if g['key'] not in keys]
    return len(new) < len(plan.groups) and \
        len(keys) + len(new) <= MAX_FUSED_GROUPS


def _overlaps(writer, reader):
    """True when ``reader``'s equation reads, or writes, a row that
    ``writer``'s writes, or may: rows ``_distinct_rows`` cannot tell
    apart count as one."""
    eq, fn = writer.eq, writer.eq.target
    rows = [(g['tk'], g['toff']) for g in reader.groups
            if g['fn'].name == fn.name]
    if reader.eq.target.name == fn.name:
        rows.append((reader.eq.time_kind, reader.eq.time_off))
    return any(not _distinct_rows(eq, tk, toff) for tk, toff in rows)


def _fuse(plans):
    """The point unit of the equations of ``plans`` (``_joins`` let each
    join the ones before it), logged and counted in ``fused``; or None when
    it cannot be built (then each keeps its own)."""
    groups, rows, staged, reach = OrderedDict(), {}, set(), {}
    for p in plans:
        for k, g in enumerate(p.groups):
            groups.setdefault(g['key'], g)
            rows.setdefault(g['key'], p.storage[1 + k])
            reach[g['key']] = tuple(max(a, b) for a, b in zip(
                reach.get(g['key'], p.reach[k]), p.reach[k]))
            if k in p.staged:
                staged.add(g['key'])
    keys = list(groups)
    storage = [p.storage[0] for p in plans] + [rows[k] for k in keys]
    apart = sum(len(p.groups) + 1 for p in plans)
    names = ', '.join(_label_name(p.eq.target) for p in plans)
    reason = (f"{len(plans)} independent equations of one region fused "
              f"({names}): {len(keys)} access groups and {len(plans)} "
              f"targets, {apart} rows apart")
    try:
        unit = StencilPlan(
            plans[0].eq, list(groups.values()),
            sorted({n for p in plans for n in p.param_names}), 'point',
            reason, [j for j, k in enumerate(keys) if k in staged],
            [j for j, k in enumerate(keys) if k not in staged], None, None,
            storage, eqs=[p.eq for p in plans], reach=[reach[k] for k in keys])
    except CompilationError as e:
        debug(f"stencil kernel: {names} stay apart ({e})")
        return None
    fused['units'] += 1
    fused['equations'] += len(plans)
    debug(f"stencil kernel: {names} run in one point unit ({len(keys)} "
          f"groups in their union, {apart - len(plans)} apart)")
    return unit


def _plan_or_reason(eq, storage=None, _design=None, _tile=None, space=None):
    """``(plan, design_reason)``, or ``(None, why the kernel declines
    eq)``."""
    space = space or _own_space
    fn = eq.target
    if fn.grid is None:
        return None, "target has no grid"
    ndim = len(eq.region)
    if ndim not in (2, 3):
        return None, f"{ndim}-D region"
    if eq.condition is not None:
        return None, "condition"
    if eq.reduction is not None:
        return None, "reduction"
    if eq.increment:
        return None, "increment"
    if np.dtype(fn.dtype) not in _CTYPE:
        return None, f"dtype {np.dtype(fn.dtype)}"
    for (s, e), (hl, hr), oo, n in zip(eq.region, fn.halo, fn.origin_offset,
                                        space(fn)):
        if hl + s - oo < 0 or hl + e - oo > n:
            return None, f"{fn.name}'s region {eq.region} writes outside " \
                f"its allocation"

    own = [d.root.name if d.is_Derived else d.name
           for d in fn.space_dimensions]
    groups = OrderedDict()
    offsets = {}
    for a in retrieve_functions(eq.rhs):
        f = a.function
        if f.is_SparseFunction:
            return None, "sparse read"
        if np.dtype(f.dtype) != np.dtype(fn.dtype):
            return None, f"mixed dtypes ({f.name})"
        dims = [d.root.name if d.is_Derived else d.name
                for d in f.space_dimensions]
        if dims != own:
            return None, f"{f.name} is not indexed like the target"
        try:
            offs = space_offsets_of(a)
        except InvalidOperator:
            return None, "absolute or non-affine index"
        tk, toff = time_access_of(a)
        if f.name == fn.name and not _distinct_rows(eq, tk, toff):
            # the kernel writes in place: a read of the written row
            # would see other threads' new values
            return None, "reads its own written row"
        for (s, e), (hl, hr), oo, o, n in zip(
                eq.region, f.halo, f.origin_offset, offs, space(f)):
            if hl + s - oo + o < 0 or hl + e - oo + o > n:
                return None, f"{a} reads outside its allocation"
        groups.setdefault(_access_key(a), {'fn': f, 'tk': tk, 'toff': toff,
                                           'key': _access_key(a)})
        offsets.setdefault(_access_key(a), set()).add(
            tuple(int(o) for o in offs))

    params, coords = [], []

    def _scan(e):
        if isinstance(e, AbstractFunction):
            return
        if isinstance(e, Dimension) or (isinstance(e, sympy.Symbol)
                                        and e.name == '__loop_time__'):
            coords.append(e)
        elif isinstance(e, sympy.Symbol):
            params.append(e.name)
        for x in getattr(e, 'args', ()):
            _scan(x)

    _scan(sympy.sympify(eq.rhs))
    if coords:
        return None, "coordinate-dependent right-hand side"
    groups = list(groups.values())
    param_names = sorted(set(params))
    storage = storage or {}
    rows = [storage.get(f.name) or torch_dtype(f.dtype)
            for f in [fn] + [g['fn'] for g in groups]]
    design, reason, staged, centre, group_radii, tile = _choose_design(
        eq, groups, [offsets[g['key']] for g in groups], _design, _tile,
        rows)
    reach = [tuple(max(abs(o[d]) for o in offsets[g['key']])
                   for d in range(ndim)) for g in groups]
    try:
        plan = StencilPlan(eq, groups, param_names, design, reason, staged,
                           centre, group_radii, tile, rows, space,
                           reach=reach)
    except CompilationError as e:
        return None, str(e)
    return plan, reason


# -- the choice of design ----------------------------------------------------

#: H100 (sm_90): shared memory an SM gives its CTAs, the most one CTA may
#: take, what the runtime reserves for each CTA, and threads an SM holds.
SM_SMEM, BLOCK_SMEM, CTA_RESERVED, SM_THREADS = 233472, 232448, 1024, 2048
#: 32-bit registers a thread may spend on its register queues. The kernel
#: asks for two CTAs per SM (__launch_bounds__), which caps a 256-thread
#: CTA at 128 registers, and the expression needs the rest: TTI's widest
#: CIRE temporary (139 flops, queues of 72 registers at two points a
#: thread) built in 128 without spills on the H100.
QUEUE_REGS = 72
#: The streaming design's tiles (TY, TZ, PY, STAGES, TX) by element size,
#: in the order ``stream_tile`` tries them. fp32's first: within 2 % of
#: the fastest tile of chip_smoke.py's sweep at 512^3 SO=8 on an H100;
#: fp64's first: half the points a thread and two stages, so its queues
#: and ring take what fp32's take (PERF.md §6). The later ones give up
#: points a thread and tile width for the rings and queues of an equation
#: of many or wide staged groups, and walk longer x-chunks: a wide group
#: primes its queue over 2rx planes a chunk (TTI's widest CIRE temporary
#: ran 7 % faster at 64 planes than at 32 on the H100).
STREAM_TILES = {4: ((16, 64, 4, 3, 32), (16, 32, 2, 2, 64),
                    (8, 32, 1, 3, 64)),
                8: ((8, 64, 2, 2, 32), (8, 32, 1, 2, 32), (4, 32, 1, 2, 32))}
STREAM_TILE = {k: v[0] for k, v in STREAM_TILES.items()}
#: The most staged groups, and the largest radius per axis, the streaming
#: design takes: what its card tests (tests/test_torch_stencil_stream.py)
#: build and check, spills and CTAs per SM included.
MAX_STAGED, MAX_RADIUS = 6, 6
#: An equation of more than FEW_STAGED staged groups streams only when its
#: widest reach is WIDE_RADIUS or more. Below it the point design's caches
#: hold each group's few taps: on the H100 at 512^3 the streaming design
#: ran 2-43 % slower than the point design on the radius-2 stars of three
#: to five groups of the elastic, visco-elastic and visco-acoustic
#: solvers, and 25-66 % faster on TTI's and the self-adjoint solver's of
#: radius 3 to 6 (PERF.md §6).
FEW_STAGED, WIDE_RADIUS = 2, 3


def _round_up(v, m):
    return -(-v // m) * m


def stream_tile(dtype, radii, nstaged=1, ncentre=0, tile=None,
                arithmetic=False):
    """The first tile of ``STREAM_TILES[dtype]`` -- or ``tile``, a (TY,
    TZ, PY, STAGES, TX) tuple -- whose rings of shared memory let two or
    more CTAs share an SM and whose queues fit ``QUEUE_REGS``, for staged
    groups of reach ``radii`` per axis (x, y, z): one (rx, ry, rz), that
    of each of ``nstaged`` groups, or a list of them, one a group (then
    ``nstaged`` is their number), and ``ncentre`` centre groups. With
    ``arithmetic`` (a point expression bound by its arithmetic, not by its
    bytes) the tiles of one point a thread go first: their fewer
    registers leave room for more CTAs an SM. Returns a
    dict of the tile (``ty, tz, py, stages, tx``), its threads, the
    union's TMA box (``box``: rows, elements a row; ``box_row_bytes``) and
    ``pitch``, each group's (``boxes``, ``pitches``, ``slots``: its ring's
    planes, ``queues``: its queue's length, ``lags``: the stages it starts
    late), ``smem_bytes``, ``ctas_per_sm`` (from shared memory and
    threads; the registers cannot lower it below 2, see QUEUE_REGS) and
    ``queue_regs``; or None when no tile fits. Mirrors
    ``csrc/stencil_stream.cuh`` ``StreamTile``."""
    size = np.dtype(dtype).itemsize
    groups = ([tuple(radii)] * nstaged if np.ndim(radii) == 1
              else [tuple(r) for r in radii])
    tiles = sorted(STREAM_TILES[size], key=lambda t: arithmetic and t[2] > 1)
    for t in [tile] if tile else tiles:
        fit = _tile_fit(size, groups, ncentre, t)
        if fit is not None:
            return fit
    return None


def _tile_fit(size, groups, ncentre, tile):
    """``stream_tile``'s dict for one tile, or None."""
    ty, tz, py, stages, tx = tile
    rx, ry, rz = (max(g[d] for g in groups) for d in range(3))
    al = 16 // size        # boxes start and end on 16-byte boundaries

    def box(ry, rz):
        return ty + 2 * ry, _round_up(tz + 2 * rz + al - 1, al)

    boxes = [box(g[1], g[2]) for g in groups]
    slots = [g[0] + stages for g in groups]
    # barriers, each group's ring of planes, the centre tiles of each stage
    smem = (128 + _round_up(8 * (rx + stages), 128)
            + sum(n * _round_up(by * bz * size, 128)
                  for n, (by, bz) in zip(slots, boxes))
            + stages * ncentre * _round_up(ty * (tz + al) * size, 128))
    threads = tz * (ty // py)
    ctas = min(SM_SMEM // (smem + CTA_RESERVED), SM_THREADS // threads,
               32) if smem <= BLOCK_SMEM else 0
    queues = [2 * g[0] + 1 for g in groups]
    qregs = py * sum(queues) * size // 4
    if ctas < 2 or qregs > QUEUE_REGS or \
            max(max(b) for b in boxes) > 256:
        return None
    by, bz = box(ry, rz)
    return dict(ty=ty, tz=tz, py=py, stages=stages, tx=tx, threads=threads,
                box=(by, bz), box_row_bytes=bz * size, pitch=bz,
                boxes=boxes, pitches=[b[1] for b in boxes], slots=slots,
                queues=queues, lags=[2 * (rx - g[0]) for g in groups],
                smem_bytes=smem, ctas_per_sm=ctas, queue_regs=qregs)


def _choose_design(eq, groups, offsets, force=None, tile=None, rows=()):
    """(design, reason, staged, centre, group radii, tile) for ``eq``,
    whose groups are read at the sets of space offsets ``offsets`` and
    whose rows (target first) are stored as ``rows``."""
    centred = {(0,) * len(eq.region)}
    staged = [k for k, o in enumerate(offsets) if o != centred]
    centre = [k for k, o in enumerate(offsets) if o == centred]

    def point(reason):
        return 'point', reason, staged, centre, None, None

    if force == 'point':
        return point("asked for")
    if len(eq.region) != 3:
        return point(f"{len(eq.region)}-D region")
    narrow = sorted({str(r).replace('torch.', '') for r in rows
                     if r in (torch.bfloat16, torch.float16)})
    if narrow:
        return point(f"narrow storage ({', '.join(narrow)} rows): the "
                     f"streaming design's TMA boxes take 4- and 8-byte "
                     f"elements")
    if _halo_extended(eq):
        return point(f"halo-extended region {eq.region}: the streaming "
                     f"design takes regions inside the domain only")
    if not staged:
        return point("no group is read off its centre")
    for k in staged:
        for o in sorted(offsets[k]):
            if sum(1 for v in o if v) > 1:
                return point(f"{groups[k]['fn'].name} is read at {o}, off "
                             f"the axes")
    group_radii = [tuple(max(abs(o[d]) for o in offsets[k])
                         for d in range(3)) for k in staged]
    radii = tuple(max(r[d] for r in group_radii) for d in range(3))
    if len(staged) > MAX_STAGED or max(radii) > MAX_RADIUS:
        return point(f"{len(staged)} staged groups, radii {radii}: the "
                     f"streaming design takes up to {MAX_STAGED}, of radius "
                     f"up to {MAX_RADIUS}")
    if len(staged) > FEW_STAGED and max(radii) < WIDE_RADIUS:
        return point(f"{len(staged)} staged groups, radii {radii}: the "
                     f"streaming design takes more than {FEW_STAGED} only "
                     f"at a radius of {WIDE_RADIUS} or more")
    # transcendental calls (TTI's trig taps unhoisted) make the kernel
    # bound by its arithmetic, not by its bytes
    arithmetic = any(not isinstance(a, AbstractFunction) for a in
                     sympy.sympify(eq.rhs).atoms(sympy.Function))
    if not arithmetic and all(sum(1 for v in r if v) == 1
                              for r in group_radii):
        # on the H100 at 512^3 the streaming design ran 19-58 % slower
        # than the point design on the elastic and visco-elastic solvers'
        # lines of radius 2 (PERF.md §6)
        return point(f"each staged group is read along one axis "
                     f"({', '.join(groups[k]['fn'].name for k in staged)}): "
                     f"the point design's caches hold a line of taps")
    fit = stream_tile(eq.target.dtype, group_radii, ncentre=len(centre),
                      tile=tile, arithmetic=arithmetic)
    if fit is None:
        return point(f"{len(staged)} staged groups, radii {radii}: no tile "
                     f"fits two CTAs per SM and {QUEUE_REGS} queue "
                     f"registers")
    names = ', '.join(groups[k]['fn'].name for k in staged)
    shapes = '' if len(set(group_radii)) == 1 else ' (' + ', '.join(
        f"{groups[k]['fn'].name} {r}" for k, r in zip(staged, group_radii)
    ) + ')'
    return ('stream', f"3-D star of {names}, radii {radii}{shapes}, tile "
            f"{fit['ty']}x{fit['tz']}x{fit['tx']}, {fit['ctas_per_sm']} "
            f"CTAs/SM", staged, centre, group_radii, fit)


def _halo_extended(eq):
    """True when ``eq``'s region starts before its target's domain or stops
    past it on some axis: CIRE's temporaries and the hoisted prologue
    items are computed into the halo (ir/lowering.py ``_halo_write``)."""
    fn = eq.target
    return any(a < oo or b > oo + n for (a, b), oo, n in zip(
        eq.region, fn.origin_offset, fn.shape[-len(eq.region):]))


def _chunk_rows(plan):
    """The rows of a chunk of ``plan``'s point launch: POINT_CHUNK_ROWS
    when the x planes its point reads keep live -- 2 rx + 1 of each
    group's, one of each target's -- would fill more than LIVE_SHARE of the
    L2 (the launch runs each x plane whole, in turn, so an x tap reads a
    plane back that many planes later); else 0, one chunk of every row. On
    the H100 at 512^3 chunks of 64 rows ran the fused units of 38-56 MB of
    live planes 6-10 % faster (elastic's velocities and stresses, TTI's
    cire0 and cire1), and units of 18-31 MB 0-7 % slower (a chunk reads its
    y taps' rows beyond it again; PERF.md §6)."""
    if plan.design != 'point' or plan.ndim != 3:
        return 0
    size = plan.dtype.itemsize

    def plane(fn):
        return size * int(np.prod(plan.space(fn)[1:]))
    live = sum((2 * r[0] + 1) * plane(g['fn'])
               for g, r in zip(plan.groups, plan.reach)) + sum(
                   plane(e.target) for e in plan.eqs)
    return POINT_CHUNK_ROWS if live > LIVE_SHARE * L2_BYTES else 0


def _distinct_rows(eq, tk, toff):
    """True when a read of the target at time access (tk, toff) provably
    touches another row than the one ``eq`` writes."""
    if tk != eq.time_kind or tk not in ('stepping', 'save', 'cond'):
        return False
    if tk == 'stepping':
        return (int(toff) - int(eq.time_off)) % eq.target._time_size != 0
    return int(toff) != int(eq.time_off)


class _CudaCtx:
    """cuda_expr context: accesses -> loads off group k's pointer at the
    point, ``g<k>``, typed by the row's storage (``DTPU_LD``); symbols ->
    kernel parameters ``a.p[i]``."""

    def __init__(self, groups, param_names, ctype):
        self.index = {g['key']: k for k, g in enumerate(groups)}
        self.params = {n: i for i, n in enumerate(param_names)}
        self.ctype = ctype

    def literal(self, v):
        s = repr(float(v))
        return s + 'f' if self.ctype == 'float' else s

    def symbol(self, sym):
        return f'a.p[{self.params[sym.name]}]'

    def access(self, e):
        k = self.index[_access_key(e)]
        offs = space_offsets_of(e)
        terms = [f'{o}LL * a.stride[{k}][{j}]'
                 for j, o in enumerate(offs[:-1]) if o]
        if offs[-1] or not terms:
            terms.append(f'{offs[-1]}')
        return f'DTPU_LD(g{k}, {" + ".join(terms)})'


def _label_name(fn):
    """``fn``'s name in a unit's comments and its point struct's name. A
    temporary of CIRE, of the hoisting pass or of an interpolation is named
    by its kind alone: the hoisting pass numbers its temporaries from a
    counter that every lowering advances, and the same equation lowered
    again must keep its unit's key."""
    if getattr(fn, '_compiler_temp', False) or getattr(fn, '_hoisted',
                                                       False):
        return 'temporary'
    return fn.name


def _point_name(*eqs):
    """The name of a unit's point struct: ``Point_<target>``, or the
    targets of a fused unit's equations joined by ``__``
    (``Point_v_x__v_y__v_z``), so that a device trace names the equations
    each K1 event ran (the struct is the kernel template's last
    argument)."""
    return 'Point_' + '__'.join(re.sub(r'\W', '_', _label_name(e.target))
                                for e in eqs)


def _unit_label(*eqs):
    """The equations a unit is generated for, without their region: the
    region reaches the kernel as launch arguments, so one unit serves every
    region of the same equations (spatial apply bounds)."""
    def one(eq):
        tk = '' if eq.time_off is None else \
            f"[{eq.time_kind}{eq.time_off:+d}]"
        return f"{_label_name(eq.target)}{tk} = ..."
    return '; '.join(one(eq) for eq in eqs)


def _generate(eqs, groups, param_names, storage):
    """The CUDA translation unit of the point design: the template plus
    the point expression of each equation of ``eqs`` (one, or a fused
    unit's), each printed as its own unit prints it, and a C entry point
    for ctypes. ``storage``: the torch dtype of each row, the targets'
    first (one type: ``_joins``), then the groups'."""
    eq, nt = eqs[0], len(eqs)
    ctype = _CTYPE[np.dtype(eq.target.dtype)]
    stypes = [_STYPE[s] for s in storage]
    ctx = _CudaCtx(groups, param_names, ctype)
    ptrs = '\n'.join(f'    const auto* g{k} = dtpu::at<{st}>(a, o, {k});'
                     for k, st in enumerate(stypes[nt:]))
    body = '\n'.join(f'    v[{j}] = {cuda_expr(e.rhs, ctx)};'
                     for j, e in enumerate(eqs))
    point = _point_name(*eqs)
    return f"""// Generated for: {_unit_label(*eqs)}
#include "stencil.cuh"

using T = {ctype};
using SO = {stypes[0]};  // the target rows' storage type
constexpr int NDIM = {len(eq.region)};
constexpr int NT = {nt};  // targets
constexpr int NG = {len(groups)};
constexpr int NP = {len(param_names)};
using Args = dtpu::StencilArgs<T, NG, NP, NT>;

namespace {{
struct {point} {{
  static __device__ __forceinline__ void eval(const long long* o,
                                              const Args& a, T (&v)[NT]) {{
{ptrs}
{body}
  }}
}};
}}  // namespace

extern "C" int dtpu_stencil_launch(void* const* ptrs, const long long* strides,
                                   const int* n, const double* params,
                                   void* stream) {{
  return dtpu::launch<T, SO, NDIM, NG, NP, NT, {point}>(
      ptrs, strides, n, params, stream);
}}
"""


class _StreamCtx(_CudaCtx):
    """cuda_expr context of the streaming design: a staged group's x taps
    read its register queue ``q[s]``, centred on its own x reach, its y
    and z taps the current plane in shared memory at ``sp[s]``, at its own
    pitch ``PZ<s>``; a centre group is the value ``cv[c]`` the kernel
    loaded from global memory for the point."""

    def __init__(self, plan, ctype):
        super().__init__(plan.groups, plan.param_names, ctype)
        self.staged = {k: s for s, k in enumerate(plan.staged)}
        self.centre = {k: c for c, k in enumerate(plan.centre)}
        self.rx = [r[0] for r in plan.group_radii]

    def access(self, e):
        k = self.index[_access_key(e)]
        if k in self.centre:
            return f'cv[{self.centre[k]}]'
        s = self.staged[k]
        dx, dy, dz = space_offsets_of(e)
        if dy:
            return f'sp[{s}][{dy} * PZ{s}]'
        if dz:
            return f'sp[{s}][{dz}]'
        return f'q[{s}][{self.rx[s] + dx}]'


def _generate_stream(plan):
    """The streaming design's translation unit of ``plan``: the template
    at the plan's radii (each staged group's own, ``dtpu::Radii``) and
    tile, each group's pitch, the point expression, and C entry points for
    ctypes. The unit asserts that ``stream_tile``'s shared memory is the
    template's."""
    eq, t = plan.eq, plan.tile
    ctype = _CTYPE[plan.dtype]
    expr = cuda_expr(eq.rhs, _StreamCtx(plan, ctype))
    names = [', '.join(_label_name(plan.groups[k]['fn']) for k in ks) or '-'
             for ks in (plan.staged, plan.centre)]
    rx, ry, rz = plan.radii
    shapes = ', '.join(str(v) for r in plan.group_radii for v in r)
    pitches = '\n'.join(f'constexpr int PZ{s} = Tile::pz({s});'
                        for s in range(len(plan.staged)))
    point = _point_name(eq)
    return f"""// Generated for: {_unit_label(eq)}
#include "stencil_stream.cuh"

using T = {ctype};
constexpr int NS = {len(plan.staged)};  // staged groups: {names[0]}
constexpr int NC = {len(plan.centre)};  // centre groups: {names[1]}
constexpr int NP = {len(plan.param_names)};
// each staged group's reach (rx, ry, rz), in the order above
using Radii = dtpu::Radii<{shapes}>;
using Tile = dtpu::StreamTile<T, NS, NC, {rx}, {ry}, {rz}, {t['ty']}, \
{t['tz']}, {t['py']}, {t['stages']}, Radii>;
using Args = dtpu::StreamArgs<T, NS, NC, NP>;
{pitches}
static_assert(Tile::SMEM == {t['smem_bytes']}, "kernels/stencil.py stream_tile \
mirrors the layout");

// In an unnamed namespace, so that the kernel and the launch template
// instantiated with it have internal linkage: another equation's library
// in the same process instantiates the same names, and a local static of
// an inline template would otherwise be one object for all of them.
namespace {{
struct {point} {{
  static __device__ __forceinline__ T eval(const T (&q)[NS][Tile::Q],
                                           const T* const (&sp)[NS],
                                           const T (&cv)[NC > 0 ? NC : 1],
                                           const Args& a) {{
    return {expr};
  }}
}};
}}  // namespace

extern "C" int dtpu_stream_launch(void* const* ptrs, const long long* dims,
                                  const int* org, const int* n,
                                  const double* params, int tx,
                                  void* stream) {{
  return dtpu::stream_launch<Tile, NP, {point}>(ptrs, dims, org, n, params,
                                                tx, stream);
}}

extern "C" int dtpu_stream_occupancy(int* ctas) {{
  return dtpu::stream_occupancy<Tile, NP, {point}>(ctas);
}}
"""


def build(plan):
    """The ctypes entry point of ``plan``'s kernel: compiled with nvcc
    into ``_build/`` and loaded at the first call, cached after."""
    lib = _nvcc.build(plan.key, 'stencil', plan.source)
    # every pointer and the stream as c_void_p: a default int would cut
    # them to 32 bits
    if plan.design == 'stream':
        fn = lib.dtpu_stream_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    else:
        fn = lib.dtpu_stencil_launch
        fn.argtypes = [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def stream_occupancy(plan):
    """CTAs of ``plan``'s streaming kernel that fit on one SM of the
    current device, as the CUDA runtime computes them from the kernel's
    registers, shared memory and threads (builds the kernel)."""
    fn = _nvcc.build(plan.key, 'stencil', plan.source).dtpu_stream_occupancy
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    check_launch(fn(ctypes.addressof(ctas)), "occupancy query")
    return ctas.value


def point_flops(plan, eq=None):
    """Operations per point of ``plan``'s kernel: the binary +, -, * and /
    of its generated point expressions, outside the loads' index
    arithmetic; of ``eq``'s alone when given (one equation of a fused
    unit)."""
    if plan.design == 'stream':
        exprs = [plan.source.split('return', 1)[1].split(';', 1)[0]]
    else:
        exprs = re.findall(r'^    v\[\d+\] = (.*);$', plan.source, re.M)
        if eq is not None:
            exprs = [exprs[next(j for j, e in enumerate(plan.eqs)
                                if e is eq)]]
    body = re.sub(r'DTPU_LD\([^()]*\)|sp\[\d+\]\[[^]]*\]|cv\[\d+\]|'
                  r'q\[\d+\]\[\d+\]', 'v', ' '.join(exprs))
    return sum(body.count(f' {op} ') for op in '+-*/')


def _outs(plan, out):
    """The target rows of ``stencil_update``'s ``rows[0]``: the row, or a
    fused unit's sequence of rows, one a target."""
    if plan.nt == 1:
        return [out]
    if isinstance(out, torch.Tensor) or len(out) != plan.nt:
        raise ValueError(f"a fused unit of {plan.nt} equations takes a "
                         f"sequence of {plan.nt} target rows")
    return list(out)


def _check_rows(plan, rows):
    outs, ins = _outs(plan, rows[0]), rows[1]
    if len(ins) != len(plan.groups):
        raise ValueError(f"{len(ins)} input rows for {len(plan.groups)} "
                         f"access groups")
    out = outs[0]
    fns = [e.target for e in plan.eqs] + [g['fn'] for g in plan.groups]
    for r, f, want in zip(outs + list(ins), fns, plan.storage):
        if not isinstance(r, torch.Tensor):
            raise TypeError(f"row of {f.name} is a {type(r).__name__}")
        if r.dtype != want:
            raise TypeError(f"row of {f.name} is {r.dtype}, the kernel "
                            f"was planned for {want}")
        if r.device != out.device:
            raise ValueError(f"row of {f.name} is on {r.device}, the "
                             f"target on {out.device}")
        if tuple(r.shape) != tuple(plan.space(f)):
            raise ValueError(f"row of {f.name} has shape {tuple(r.shape)}; "
                             f"expected {plan.space(f)}")
        if not r.is_contiguous():
            raise ValueError(f"row of {f.name} is not contiguous")


def stencil_update(plan, rows, params):
    """Write ``plan.eq``'s right-hand side over its region into the target
    row, in place: each of a fused unit's ``plan.eqs`` into its own, in one
    launch. ``rows`` is ``(target row, [one row per group])`` -- a fused
    unit's first item is a sequence of target rows, one an equation --
    each a halo'd row tensor of its function; ``params`` maps symbol names
    to values. CUDA tensors go through the kernel, each launch from the
    rows' checks to the kernel's return in the span ``dtpu::k1.launch``
    (utils/tools.py ``span``); CPU tensors through
    ``stencil_update_reference``."""
    out = _outs(plan, rows[0])[0]
    if isinstance(out, torch.Tensor) and out.device.type == 'cuda':
        with span('dtpu::k1.launch'):
            _check_rows(plan, rows)
            _launch(plan, _outs(plan, rows[0]), rows[1], params)
        return
    _check_rows(plan, rows)
    if out.device.type == 'cpu':
        return stencil_update_reference(plan, rows, params)
    raise ValueError(f"no stencil kernel for device {out.device}")


def _launch(plan, outs, ins, params):
    """``stencil_update``'s launch of ``plan``'s unit on CUDA rows that
    ``_check_rows`` passed: ``outs`` the target rows, ``ins`` the
    groups'."""
    global launches
    out = outs[0]
    if out.device not in validated:
        validate_backend(out.device)
    entry = build(plan)
    for i, name in enumerate(plan.param_names):
        plan._params[i] = float(params[name])
    plan._n[3] = plan.chunk_rows
    if plan.design == 'stream':
        rows = [out] + list(ins)
        for i, r in enumerate(plan._rows):
            if rows[r].data_ptr() % 16:
                raise ValueError("the streaming kernel's rows must start on "
                                 "16-byte boundaries (TMA)")
            plan._ptrs[i] = rows[r].data_ptr()
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = entry(ctypes.addressof(plan._ptrs),
                       ctypes.addressof(plan._dims),
                       ctypes.addressof(plan._org),
                       ctypes.addressof(plan._n),
                       ctypes.addressof(plan._params), plan.tile['tx'],
                       stream)
        if rc < 0:
            raise RuntimeError(f"streaming stencil kernel for {plan.eq!r}: "
                               f"no tensor map (cuTensorMapEncodeTiled "
                               f"returned {-rc}; 100000: not found)")
        check_launch(rc, f"streaming stencil kernel for {plan.eq!r}")
        launches += 1
        launches_by_design['stream'] += 1
        plan.launches += 1
        return
    for i, (r, org) in enumerate(zip(outs + list(ins), plan.origins)):
        st = r.stride()
        plan._ptrs[i] = r.data_ptr() + r.element_size() * sum(
            o * s for o, s in zip(org, st))
        plan._strides[2 * i] = st[0]
        plan._strides[2 * i + 1] = st[1] if plan.ndim == 3 else 0
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(ctypes.addressof(plan._ptrs),
                   ctypes.addressof(plan._strides),
                   ctypes.addressof(plan._n),
                   ctypes.addressof(plan._params), stream)
    check_launch(rc, f"stencil kernel for {plan.eq!r}")
    launches += 1
    launches_by_design['point'] += 1
    plan.launches += 1


class _RowsCtx:
    """translate context over the plan's rows: an access is the group
    row's region window shifted by the access's offsets."""

    def __init__(self, plan, ins, params):
        self.plan = plan
        self.rows = {g['key']: (r, org) for g, r, org
                     in zip(plan.groups, ins, plan.origins[plan.nt:])}
        self.params = params

    def symbol(self, sym):
        if sym.name in self.params:
            return self.params[sym.name]
        raise CompilationError(f"Unbound symbol {sym.name}")

    def access(self, e):
        row, org = self.rows[_access_key(e)]
        return widen(row[tuple(slice(s + o, s + o + n) for s, o, n in zip(
            org, space_offsets_of(e), self.plan.extents))], e.function)


def stencil_update_reference(plan, rows, params):
    """The plain PyTorch version of ``stencil_update``: the same
    right-hand side through the torch translator, over the same region,
    written into the same row; a fused unit's each into its own, after
    all are evaluated. A narrow row is widened to the compute dtype where
    it is read, and the value rounds to the target row's dtype (to nearest
    even) where it is written."""
    outs, ins = _outs(plan, rows[0]), rows[1]
    ctx = _RowsCtx(plan, ins, params)
    vals = [translate(e.rhs, ctx) for e in plan.eqs]
    for out, org, val in zip(outs, plan.origins, vals):
        dst = out[tuple(slice(s, s + n)
                        for s, n in zip(org, plan.extents))]
        val = torch.as_tensor(val, dtype=torch_dtype(plan.dtype),
                              device=out.device)
        dst.copy_(val.to(out.dtype).expand(dst.shape))


# -- K2: the self-test ------------------------------------------------------

_H, _T, _NZ, _ZP = 2, 4, 16, 128
#: The self-test's input and output shapes.
SELFTEST_SHAPE = (2 * _T + 2 * _H, _T + 2 * _H, _ZP)
SELFTEST_OUT = (2 * _T, _T, _ZP)
#: K2's ctypes entry point, once ``selftest_window_sum`` has built it.
_selftest_entry = None


def selftest_window_sum(x, out=None):
    """K2's computation on ``x`` of shape ``SELFTEST_SHAPE`` (fp32): for
    each of the 2 tiles i, the window ``w = x[i*T : i*T+T+2H, :T+2H]``
    gives ``w[H:-H, H:-H, H:H+NZ] + w[H+1:H+1+T, H:-H, H+1:H+1+NZ]``,
    zero-padded from NZ to ZP lanes; the tiles stack along axis 0 into a
    (2T, T, ZP) tensor: ``out`` when given (contiguous, fp32, on x's
    device; written, never copied), else a new one. CUDA tensors go
    through the kernel (``csrc/selftest.cu``: one CTA loading both windows
    as TMA boxes into a two-slot ring on mbarriers); CPU tensors through
    ``selftest_window_sum_reference``.

    The host path is K12's (``experiments/stencil_probe7.py``
    ``empty_grid``): the entry point is resolved once, the device guard is
    in C, and the stream is read raw at each call."""
    global selftest_launches, _selftest_entry
    if not isinstance(x, torch.Tensor) or x.dtype is not torch.float32 or \
            x.shape != SELFTEST_SHAPE or not x.is_contiguous():
        raise ValueError(f"the self-test takes a contiguous fp32 tensor of "
                         f"shape {SELFTEST_SHAPE}")
    if out is not None and (
            not isinstance(out, torch.Tensor) or
            out.dtype is not torch.float32 or out.shape != SELFTEST_OUT or
            not out.is_contiguous() or out.device != x.device):
        raise ValueError(f"out: expected a contiguous fp32 tensor of shape "
                         f"{SELFTEST_OUT} on {x.device}")
    dev = x.device
    if dev.type == 'cpu':
        return selftest_window_sum_reference(x) if out is None else \
            selftest_window_sum_reference(x, out)
    if dev.type != 'cuda':
        raise ValueError(f"no self-test kernel for device {dev}")
    if x.data_ptr() % 16:
        raise ValueError("the self-test kernel's input must start on a "
                         "16-byte boundary (TMA)")
    if out is None:
        out = torch.empty(SELFTEST_OUT, dtype=torch.float32, device=dev)
    fn = _selftest_entry
    if fn is None:
        fn = _selftest_entry = _nvcc.entry(
            'selftest', 'dtpu_selftest_launch',
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p])
    index = dev.index
    rc = fn(x.data_ptr(), out.data_ptr(), index,
            torch._C._cuda_getCurrentRawStream(index))
    if rc < 0:
        raise RuntimeError(f"self-test kernel: no tensor map "
                           f"(cuTensorMapEncodeTiled returned {-rc}; "
                           f"100000: not found)")
    check_launch(rc, "self-test kernel")
    selftest_launches += 1
    return out


def selftest_window_sum_reference(x, out=None):
    """The plain PyTorch version of ``selftest_window_sum``; into ``out``
    when given."""
    if out is None:
        out = x.new_zeros(SELFTEST_OUT)
    else:
        out.zero_()
    for i in range(2):
        w = x[i * _T:i * _T + _T + 2 * _H, :_T + 2 * _H]
        out[i * _T:(i + 1) * _T, :, :_NZ] = (
            w[_H:-_H, _H:-_H, _H:_H + _NZ]
            + w[_H + 1:_H + 1 + _T, _H:-_H, _H + 1:_H + 1 + _NZ])
    return out


def validate_backend(device='cuda'):
    """Run the self-test on ``device`` and check its whole output: 2.0 on
    lanes [0, NZ) and 0 beyond, for ones in. Raises CompilationError on
    any other answer; returns True. ``stencil_update`` runs it once per
    process and device, before its first kernel launch there; each run
    adds one to ``selftests``."""
    global selftests
    x = torch.ones(SELFTEST_SHAPE, dtype=torch.float32,
                   device=torch.device(device))
    out = selftest_window_sum(x)
    selftests += 1
    want = torch.zeros((2 * _T, _T, _ZP), dtype=torch.float32)
    want[..., :_NZ] = 2.0
    got = out.cpu()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise CompilationError(
            f"the self-test kernel gave a wrong answer on {out.device}: "
            f"{bad} of {want.numel()} values differ from 2.0 on lanes "
            f"[0, {_NZ}) and 0 beyond (max |diff| "
            f"{(got - want).abs().max().item():.3e})")
    validated.add(out.device)
    return True
