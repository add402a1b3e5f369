"""Multi-device runs: the halo plan and the sharded runner.

Reference parity: devito_tpu/parallel/halo.py (itself the analog of
devito/mpi/halo_scheme.py HaloScheme.classify:571 and the exchange schemes
of devito/mpi/routines.py, overlap2 among them, routines.py:778).

devito_tpu runs a distributed Grid's Operator in one process over a mesh
of shards: ``shard_map`` runs the executor per shard and ``ppermute``
refreshes the halos. This module keeps that design with torch tensors:

- the analysis is devito_tpu's, line for line: ``halo_scheme``,
  ``item_reads``/``item_writes``, the dataflow ``plan_halos`` (ghost zones
  for same-step producer-consumer chains, the top-of-step batch, mid-step
  refreshes where the ghost-zone budget cannot cover a chain) and
  ``explicit_halo_eligible``;
- ``ShardedRunner`` builds devito_tpu's local schedule, item for item:
  regions localized to a shard (ghost-zone-extended writes, global-
  coordinate masks for sub-domain writes and the uneven last shard through
  ``__shard_off_<dim>__``), the body split into interior regions, which read
  no halo, and boundary frames, with the ``ExchangeStart``/``ExchangeFinish``
  markers between them (``ExchangeSync`` where the split does not apply);
- every shard holds its own tensors, padded to a local halo'd layout; the
  exchange is ``copy_`` between them (a device copy when shards share a
  card, a peer copy between cards), one axis after the other so that the
  corners compose, and ``ShardedRunner.exchange`` counts the copies and
  their bytes. On a CUDA device ``ExchangeStart`` issues the copies on a
  side stream, ordered by CUDA events, and ``ExchangeFinish`` makes the
  compute stream wait for them, so the copies may overlap the interior
  updates; elsewhere they run in place of the markers;
- the executor (compiler/executor.py, ``build_runner(shard_spec=...)``)
  runs each item on every shard, combines contractions and reductions over
  partitioned dimensions across the shards (devito_tpu's psum/pmax/pmin),
  and adds the interpolations' per-shard partial sums; sparse points are
  bucketed by owner (``bucket_sparse_points``).

A schedule that ``explicit_halo_eligible`` rejects runs gathered under
``configuration['halo'] = 'auto'``: the Operator's unsharded runner on the
functions' whole tensors, which live on the mesh's first device (devito_tpu
runs such schedules through XLA's SPMD partitioner, which has no
counterpart here); under 'explicit' it raises InvalidArgument.

Between applies a function's tensor is its whole (global) halo'd tensor on
its device, as devito_tpu's is one global jax.Array: ``prepare_buffers``
cuts the shards from it at the start of an apply and ``restore`` writes
their interiors back at its end.
"""

import numpy as np
import torch

from ..ir.lowering import LoweredEq, LoweredSparse, time_access_of
from ..types.basic import retrieve_functions
from ..ir.lowering import space_offsets_of
from ..logger import perf as log_perf

__all__ = ['halo_scheme', 'plan_halos', 'explicit_halo_eligible',
           'explicit_halo_reason', 'bucket_sparse_points', 'partitions',
           'local_space', 'ShardedRunner',
           'ExchangeStart', 'ExchangeFinish', 'ExchangeSync']


def halo_scheme(schedule):
    """Which (function, time_kind, toff) reads need valid halos, and how
    wide per space dim — the analog of HaloScheme.classify (reference
    mpi/halo_scheme.py:571)."""
    needs = {}

    def scan_expr(expr):
        for a in retrieve_functions(expr):
            fn = a.function
            if fn.is_SparseFunction or fn.grid is None:
                continue
            offs = space_offsets_of(a, absolute='zero')
            if not any(offs):
                continue
            tk, toff = time_access_of(a)
            key = (fn.name, tk, toff)
            cur = needs.setdefault(key, [0] * len(offs))
            for j, o in enumerate(offs):
                cur[j] = max(cur[j], abs(o))

    # prologue/epilogue included: hoisted invariants (e.g. a lifted
    # parameter derivative) read their operands at offsets outside the
    # time loop and need filled halos just the same
    for it in schedule.all_items:
        if isinstance(it, LoweredEq):
            scan_expr(it.rhs)
            if it.condition is not None:
                scan_expr(it.condition)
        else:
            scan_expr(it.expr)
    return needs


def _canon_row(fn, tk, toff):
    """Canonical row key: stepping offsets alias modulo the slot count."""
    if tk == 'stepping':
        toff = int(toff) % fn._time_size
    return (fn.name, tk, toff)


def item_reads(item):
    """All grid-function row reads of a schedule item with their per-axis
    tap margins: {rowkey: [margin per grid axis]} (zero-margin reads
    included — taint propagation needs them)."""
    out = {}

    def scan(expr, extra=0):
        for a in retrieve_functions(expr):
            fn = a.function
            if fn.is_SparseFunction or fn.grid is None:
                continue
            offs = space_offsets_of(a, absolute='zero')
            tk, toff = time_access_of(a)
            key = _canon_row(fn, tk, toff)
            cur = out.setdefault(key, [0] * len(offs))
            for j, o in enumerate(offs):
                cur[j] = max(cur[j], abs(o) + extra)

    if isinstance(item, LoweredEq):
        scan(item.rhs)
        if item.condition is not None:
            scan(item.condition)
        if item.increment or item.reduction:
            # read-modify-write of the target's current content
            fn = item.target
            key = _canon_row(fn, item.time_kind, item.time_off)
            out.setdefault(key, [0] * len(fn.space_dimensions))
    elif isinstance(item, LoweredSparse):
        # corner gathers read at clipped in-domain indices plus any
        # symbolic offsets of the sampled expression; an offset read of
        # a point owned right at the shard edge lands in the halo
        scan(item.expr)
    return out


def item_writes(item):
    """Row keys written by a schedule item (dense targets and sparse
    injection fields)."""
    if isinstance(item, LoweredEq):
        fn = item.target
        if fn.grid is None or fn.is_SparseFunction:
            return []
        return [_canon_row(fn, item.time_kind, item.time_off)]
    if isinstance(item, LoweredSparse) and item.kind == 'inject':
        fn = item.field
        return [_canon_row(fn, item.field_time_kind,
                           item.field_time_off)]
    return []


class HaloPlan:
    """WHERE and HOW each halo gets refreshed on the explicit path.

    - ``static``: {rowkey: margins} — rows whose content never changes
      before their reads (params, read-only save buffers): halos filled
      once at shard-entry pad time.
    - ``after_prologue``: {rowkey: margins} — rows written in the
      prologue and tap-read later: one exchange batch before the loop.
    - ``top``: {rowkey: margins} — per-step batch at the top of the
      step (carry rows, plus pre-write refreshes of increment targets
      with ghost-zone extensions).
    - ``ext``: {id(body eq): [e per axis]} — ghost zones: the eq's write
      region is extended ``e`` into its allocated halo so same-step
      consumers read locally-computed values (deep-halo scheme; the
      upstream margins in ``top`` are widened by the backward dataflow).
    - ``mid``: {body index: {rowkey: margins}} — synchronous refresh
      markers before specific body items, for chains the ghost-zone
      budget cannot cover.
    - ``epi``: {rowkey: margins} — one batch before the epilogue.
    - ``overlap_ok``: every per-step exchange sits in the top batch, so
      the interior/frame overlap split applies.
    """

    def __init__(self):
        self.static = {}
        self.after_prologue = {}
        self.top = {}
        self.ext = {}
        self.mid = {}
        self.epi = {}
        self.overlap_ok = True
        self.notes = []

    def _bump(self, table, key, margins):
        cur = table.setdefault(key, [0] * len(margins))
        for j, m in enumerate(margins):
            cur[j] = max(cur[j], m)


def plan_halos(schedule, reads):
    """Dataflow pass assigning every halo-needing read a refresh point.

    ``reads``: {name: fn} for every function in the operator.  Returns a
    HaloPlan, or None when the schedule cannot be planned (a row written
    more than once per step and tap-read — ambiguous single-pass
    dataflow; the schedule then runs gathered)."""
    body = schedule.body
    plan = HaloPlan()

    written_body = {}
    for i, it in enumerate(body):
        for w in item_writes(it):
            written_body.setdefault(w, []).append(i)
    written_pro = set()
    for it in schedule.prologue:
        written_pro.update(item_writes(it))

    # --- backward pass over the body: ghost-zone extensions ---------------
    need = {}          # row -> margins required valid at read time
    sync_rows = set()  # rows needing synchronous mid-step refresh
    for i in reversed(range(len(body))):
        it = body[i]
        bump = None
        for w in item_writes(it):
            e = need.pop(w, None)
            if e is None or not any(e):
                continue
            fn = (it.target if isinstance(it, LoweredEq) else it.field)
            cap = [min(hl, hr) for (hl, hr) in fn.halo]
            ok = (isinstance(it, LoweredEq)
                  and len(written_body.get(w, ())) == 1
                  and all(ej <= cj for ej, cj in zip(e, cap)))
            if ok:
                sshape = (fn.shape[1:] if fn.is_TimeFunction
                          else fn.shape)
                ok = tuple(it.region) == tuple((0, n) for n in sshape)
            if ok:
                plan.ext[id(it)] = list(e)
                if (it.increment or it.reduction is not None
                        or it.condition is not None):
                    # the extended region's pre-update content must be
                    # fresh before the read-modify-write
                    plan._bump(plan.top, w, e)
                bump = list(e)
            else:
                sync_rows.add(w)
                plan.overlap_ok = False
        if isinstance(it, LoweredEq) or isinstance(it, LoweredSparse):
            for r, m in item_reads(it).items():
                mm = ([x + b for x, b in zip(m, bump)] if bump else m)
                plan._bump(need, r, mm)

    # save/cond row keys do not alias across steps the way canonical
    # stepping rows do: the row read as toff=0 this step was written as
    # toff=1 LAST step under a different key.  Any tap-read row of a
    # function whose rows are written in the body is therefore stale at
    # step top and needs the per-step batch, never the static fill.
    body_written_fns = {name for (name, tk, toff) in written_body}

    # rows never written in the body: where does their content come from?
    for r, m in need.items():
        if r in written_body:
            continue  # resolved above (ghost/sync)
        if not any(m):
            continue
        if r[0] in body_written_fns and r[1] in ('save', 'cond'):
            plan._bump(plan.top, r, m)
        elif r in written_pro:
            plan._bump(plan.after_prologue, r, m)
        elif r[1] in ('save', 'cond') or r[1] is None:
            plan._bump(plan.static, r, m)
        else:
            plan._bump(plan.top, r, m)
    # carry rows written in the body and read with taps at the NEXT step
    # (their need was popped by the backward pass only for same-step
    # chains): a forward walk catches reads occurring before the write
    pending = set(written_body)
    for it in body:
        for r, m in item_reads(it).items():
            if r in pending and any(m):
                plan._bump(plan.top, r, m)
                pending.discard(r)
        for w in item_writes(it):
            pending.discard(w)

    # --- forward pass: mid-step markers for sync rows ---------------------
    if sync_rows:
        stale = set(sync_rows)
        for i, it in enumerate(body):
            for r, m in item_reads(it).items():
                if r in stale and any(m):
                    plan._bump(plan.mid.setdefault(i, {}), r, m)
                    stale.discard(r)
            for w in item_writes(it):
                if w in sync_rows:
                    stale.add(w)

    # --- epilogue: refresh rows changed during the run --------------------
    changed = set(written_body) | written_pro
    changed_fns = set(body_written_fns)
    for it in schedule.epilogue:
        for r, m in item_reads(it).items():
            if not any(m):
                continue
            if r in changed or r[0] in changed_fns:
                plan._bump(plan.epi, r, m)
            else:
                plan._bump(plan.static, r, m)
        changed.update(item_writes(it))
        changed_fns.update(name for (name, tk, toff) in item_writes(it))

    # prologue-internal chains: a prologue item tap-reading a row written
    # by an earlier prologue item — rare; refresh inline is not yet
    # supported, signal no-plan
    seen = set()
    for it in schedule.prologue:
        for r, m in item_reads(it).items():
            if any(m) and r in seen:
                return None
            if any(m) and r not in seen and r not in plan.static:
                plan._bump(plan.static, r, m)
        seen.update(item_writes(it))

    # double-written tap-read rows are ambiguous for the single-pass
    # dataflow — the schedule runs gathered
    for r in sync_rows:
        if len(written_body.get(r, ())) > 1:
            return None
    return plan




def explicit_halo_reason(op):
    """None when the operator's schedule can run on the explicit halo path,
    else why not (devito_tpu's ``explicit_halo_eligible`` rules, each with
    its reason)."""
    grid = op._grid
    if grid is None or grid.distributor is None:
        return "the grid is not distributed"
    schedule = op._schedule

    # uneven axes shard at ceil(n/t) with a dead-padded last shard
    # (ShardedRunner docstring) -- no divisibility requirement; sub-domain
    # writes, space conditions, reductions and matrix/precomputed sparse
    # functions all run on this path, as in devito_tpu

    # exchanged buffers must have reconstructible halos and enough
    # allocated halo for the (ghost-bumped) exchange widths
    needs = halo_scheme(schedule)
    for (name, tk, toff) in needs:
        fn = op._reads.get(name)
        if fn is None:
            return f"{name} is read with taps but is not an operand"
        state = getattr(fn, 'halo_state', 'dirty')
        if tk in ('stepping', 'save', 'cond') and state != 'zero':
            return f"{name}'s halo is {state!r}, not 'zero'"
        if tk is None and state not in ('zero', 'edge'):
            return f"{name}'s halo is {state!r}"

    plan = plan_halos(schedule, op._reads)
    if plan is None:
        return ("a row written more than once a step is read with taps, "
                "or a prologue item tap-reads a row another one writes")
    for table in (plan.static, plan.after_prologue, plan.top, plan.epi,
                  *plan.mid.values()):
        for (name, tk, toff), margins in table.items():
            fn = op._reads.get(name)
            if fn is None:
                return f"{name} is read with taps but is not an operand"
            for m, (hl, hr) in zip(margins, fn.halo):
                if m > min(hl, hr):
                    return (f"{name}'s exchange width {m} exceeds its halo "
                            f"{(hl, hr)}")
    # pro/epi batches run outside the time loop: no t to resolve a
    # time-indexed row with
    for table in (plan.after_prologue, plan.epi):
        for (name, tk, toff) in table:
            if tk is not None:
                return (f"{name} ({tk}) needs an exchange outside the time "
                        f"loop")
    return None


def explicit_halo_eligible(op):
    """True iff the operator's schedule can run on the explicit halo path
    (devito_tpu's rules; ``explicit_halo_reason`` says why not)."""
    return explicit_halo_reason(op) is None


class HaloMarker:
    """An executor-schedulable halo action (compiler/executor.py runs it on
    ``kind == 'halo'`` with every shard's tensors)."""
    kind = 'halo'

    def run(self, sbufs, sparams, t):  # pragma: no cover - abstract
        raise NotImplementedError


class ExchangeSync(HaloMarker):
    """Refresh the halos of ``rows`` ([(fn, tk, toff, margins)]) in place,
    on the compute stream; ``exchange_row`` is the ShardedRunner's row
    refresh."""

    def __init__(self, rows, exchange_row):
        self.rows = rows
        self.exchange_row = exchange_row

    def run(self, sbufs, sparams, t):
        for fn, tk, toff, margins in self.rows:
            self.exchange_row(sbufs, sparams, t, fn, tk, toff, margins)


class ExchangeStart(HaloMarker):
    """Begin the top-of-step exchange batch. The interior updates that
    follow read no halo, so they do not wait for it: on a CUDA device the
    copies go to a side stream after an event of the compute stream
    (reference overlap2, mpi/routines.py:778)."""

    def __init__(self, rows, refresh_row):
        self.rows = rows
        self.refresh_row = refresh_row

    def run(self, sbufs, sparams, t):
        for fn, tk, toff, margins in self.rows:
            self.refresh_row(sbufs, sparams, t, fn, tk, toff, margins)


class ExchangeFinish(HaloMarker):
    """End the batch: the compute stream waits for the side stream's copies
    before the boundary frames read the refreshed halos."""

    def __init__(self, rows, writeback_row):
        self.rows = rows
        self.writeback_row = writeback_row

    def run(self, sbufs, sparams, t):
        self.writeback_row()


def _slab(row, ax, lo, hi):
    idx = [slice(None)] * row.dim()
    idx[ax] = slice(lo, hi)
    return row[tuple(idx)]


def bucket_sparse_points(coords, grid, topology, radius):
    """Owner buckets of sparse points over the shard topology (devito_tpu's
    rule, halo.py:494): for each shard, the indices of the points whose
    interpolation support (``radius`` grid points each way around the
    point) can touch a cell the shard owns. A point interior to one shard
    is in its bucket only; one whose support straddles a boundary is in
    every shard's it overlaps (the ownership localization masks its foreign
    corners). Returns an int32 array shaped ``topology + (C,)``, ``C`` the
    largest bucket, -1-padded."""
    coords = np.asarray(coords)
    P = coords.shape[0]
    ndim = len(topology)
    lo = np.zeros((P, ndim), dtype=np.int64)
    hi = np.zeros((P, ndim), dtype=np.int64)
    for j in range(ndim):
        h = grid.spacing[j]
        o = grid.origin[j]
        n = grid.shape[j]
        t = topology[j]
        lext = -(-n // t)
        px = (coords[:, j] - o) / h
        base = np.floor(px).astype(np.int64)
        lo[:, j] = np.clip((base - radius) // lext, 0, t - 1)
        hi[:, j] = np.clip((base + radius) // lext, 0, t - 1)
    buckets = {}
    for p in range(P):
        ranges = [range(lo[p, j], hi[p, j] + 1) for j in range(ndim)]
        idx = [()]
        for r in ranges:
            idx = [i + (s,) for i in idx for s in r]
        for s in idx:
            buckets.setdefault(s, []).append(p)
    C = max((len(v) for v in buckets.values()), default=1)
    C = max(C, 1)
    out = np.full(tuple(topology) + (C,), -1, dtype=np.int32)
    for s, pts in buckets.items():
        out[s + (slice(0, len(pts)),)] = pts
    return out


def partitions(grid):
    """{dim name: (axis name, shards along it, local extent, global
    extent)} of a distributed grid's partitioned dimensions; the local
    extent is ceil(n / t), so an uneven axis pads its last shard with dead
    cells, kept at halo semantics (zero for written fields, edge values
    for 'edge' params)."""
    dist = grid.distributor
    return {d.name: (axn, t, -(-n // t), n) for d, axn, t, n in zip(
        grid.dimensions, dist.axis_names, dist.topology, grid.shape) if t > 1}


def local_space(fn, parts):
    """A shard's halo'd extent per space axis of ``fn``: the local extent
    on partitioned axes (``partitions``), the whole one elsewhere, the
    innermost rounded up to 128 (devito_tpu's ``_pad_local``), so that its
    rows start on 512-byte boundaries as the whole tensor's do."""
    out = []
    for d, n, (hl, hr) in zip(fn.space_dimensions, type(fn)._space_shape,
                              fn.halo):
        part = parts.get(d.name)
        out.append(hl + (part[2] if part else n) + hr)
    if out:
        out[-1] = -(-out[-1] // 128) * 128
    return tuple(out)


class Shard:
    """One shard of the mesh: its index in mesh (C) order, its mesh
    coordinates, its device, and its global offset and live extent per
    partitioned dimension (the uneven last shard's live extent is short;
    a shard past the domain has none)."""

    def __init__(self, index, coords, device, offsets, live):
        self.index = index
        self.coords = coords
        self.device = device
        self.offsets = offsets
        self.live = live

    @property
    def params(self):
        """The shard's ``__shard_off_<dim>__`` parameters."""
        return {f'__shard_off_{d}__': o for d, o in self.offsets.items()}

    def __repr__(self):
        return f"Shard({self.index}, {self.coords}, {self.device})"


class ShardedRunner:
    """The sharded executor of one Operator on a distributed Grid.

    ``local_schedule``: devito_tpu's per-shard schedule (localized regions,
    ghost zones, the interior/frame split and the exchange markers);
    ``plan``: its HaloPlan; ``parts``: {dim name: (axis name, shards
    along it, local extent, global extent)} of the partitioned dimensions;
    ``shards``: the Shards in mesh order; ``runner``: the executor
    (compiler/executor.py) over every shard; ``exchange``: the copies and
    bytes the exchange has moved ('copies', 'bytes', cumulative), and the
    slab copies a step of the top batch ('step_copies', 'step_bytes')
    once an apply has cut the shards.
    """

    def __init__(self, op):
        from ..compiler.executor import build_runner
        from ..ir.lowering import Schedule

        self.op = op
        grid = op._grid
        dist = grid.distributor
        self.dist = dist
        self.grid = grid
        self.parts = partitions(grid)

        # the halo plan drives where every refresh happens (eligibility
        # proved that it exists and fits the allocated halos)
        self.plan = plan_halos(op._schedule, op._reads)

        sched = op._schedule
        pro = [self._localize(it) for it in sched.prologue]
        body = []
        for i, it in enumerate(sched.body):
            loc = self._localize(it)
            loc._section = i
            body.append(loc)
        epi = [self._localize(it) for it in sched.epilogue]

        self._cuda_side = {}
        self.exchange = {'copies': 0, 'bytes': 0}
        pro, body, epi = self._place_exchanges(pro, body, epi, sched)
        self.local_schedule = Schedule(pro, body, epi, sched.direction)

        dims = [d.name for d in grid.dimensions]
        self.shards = []
        for i, (coords, dev) in enumerate(np.ndenumerate(dist.mesh)):
            offsets, live = {}, {}
            for dn, (axn, t, lext, n) in self.parts.items():
                off = coords[dims.index(dn)] * lext
                offsets[dn] = off
                live[dn] = max(0, min(lext, n - off))
            self.shards.append(Shard(i, coords, dev, offsets, live))
        # the shards along each partitioned dimension, line by line
        self._lines = {}
        for dn in self.parts:
            j = dims.index(dn)
            lines = {}
            for sh in self.shards:
                key = sh.coords[:j] + sh.coords[j + 1:]
                lines.setdefault(key, []).append(sh.index)
            self._lines[dn] = list(lines.values())
        sections = [f'dtpu_sec{it._section}' if isinstance(
            it, (LoweredEq, LoweredSparse)) else 'dtpu_exchange'
            for it in self.local_schedule.body]
        self.runner = build_runner(self.local_schedule, op._storage,
                                   op._errctl, sections, shard_spec=self)

    # -- the local schedule ------------------------------------------------

    def _localize(self, it):
        """Map an eq's global region to the per-shard domain.

        Partitioned axes: a full-domain write localizes directly (plus any
        ghost-zone extension); a sub-region write becomes a full-local-
        domain write guarded by a GLOBAL-coordinate mask condition (bare
        dimensions translate with the shard offset), the analog of the
        reference's owned-region clamping of SubDimension loop bounds.
        Unpartitioned axes keep their static sub-region."""
        import sympy
        if isinstance(it, LoweredSparse):
            return it
        ext = self.plan.ext.get(id(it))
        fn = it.target
        sshape = fn.shape[1:] if fn.is_TimeFunction else fn.shape
        region = []
        guards = []
        for j, (d, N) in enumerate(zip(fn.space_dimensions, sshape)):
            a, b = it.region[j]
            if d.name not in self.parts:
                region.append((a, b))
                continue
            _, nparts, n, _ = self.parts[d.name]
            uneven = n * nparts != N
            if (a, b) == (0, N):
                e = ext[j] if ext else 0
                region.append((-e, n + e))
                if uneven:
                    # dead cells of the last shard (global index >= N)
                    # stay at their halo semantics: mask the write by the
                    # global coordinate
                    guards.append(d < N)
            else:
                region.append((0, n))
                if a > 0:
                    guards.append(d >= a)
                if b < N or uneven:
                    guards.append(d < b)
        condition = it.condition
        if guards:
            mask = sympy.And(*guards) if len(guards) > 1 else guards[0]
            condition = (mask if condition is None
                         else sympy.And(condition, mask))
        loc = LoweredEq(fn, it.time_off, it.time_kind,
                        tuple(region), it.rhs, increment=it.increment,
                        reduction=it.reduction, condition=condition,
                        time_dep=it.time_dep, cond_factor=it.cond_factor,
                        lhs_access=it.lhs_access)
        # the global region, for a region computed into the halo (CIRE's
        # temporaries, hoisted prologue items): the outermost shards
        # extend theirs past the domain as the whole run does
        # (compiler/executor.py shard_item)
        loc.global_region = it.region
        return loc

    def _rows_of(self, table):
        """plan table -> [(fn, tk, toff, margins)] restricted to nonzero
        margins on partitioned axes."""
        reads = self.op._reads
        rows = []
        for (name, tk, toff), margins in table.items():
            fn = reads[name]
            eff = [m if d.name in self.parts else 0
                   for d, m in zip(fn.space_dimensions, margins)]
            if any(eff):
                rows.append((fn, tk, toff, eff))
        return rows

    def _split_shrinks(self, body, top_keys):
        """Per-eq interior shrink widths (partitioned axes) via forward
        accumulation: an eq's interior must avoid both the exchanged
        halos and any upstream same-phase frame region."""
        shrinks = {}          # id(item) -> [s per space axis]
        writer_shrink = {}    # rowkey -> accumulated shrink of its writer
        for it in body:
            if not isinstance(it, LoweredEq):
                continue
            naxes = len(it.target.space_dimensions)
            s = [0] * naxes
            for rowkey, m in item_reads(it).items():
                up = writer_shrink.get(rowkey)
                if rowkey in top_keys:
                    s = [max(a, b) for a, b in zip(s, m)]
                if up is not None:
                    s = [max(a, u + b) for a, u, b in zip(s, up, m)]
            eff = [sj if d.name in self.parts else 0
                   for d, sj in zip(it.target.space_dimensions, s)]
            shrinks[id(it)] = eff
            for w in item_writes(it):
                prev = writer_shrink.get(w)
                writer_shrink[w] = ([max(a, b) for a, b in zip(prev, eff)]
                                    if prev else eff)
        return shrinks

    def _split_eq(self, it, s):
        """(interior variant, [frame variants]) of a dense eq for shrink
        widths ``s``; onion decomposition over the shrunk axes. The
        interior is clamped to the local domain (a ghost-extended region
        starts inside the halo, which is frame territory by definition)."""
        from copy import copy as _c
        if not any(s):
            return it, []
        interior = []
        for d, (a, b), sj in zip(it.target.space_dimensions, it.region, s):
            if not sj:
                interior.append((a, b))
                continue
            ia, ib = sj, self.parts[d.name][2] - sj
            if ib <= ia:
                return None, None  # shard too narrow: no split
            interior.append((ia, ib))
        inner = _c(it)
        inner.region = tuple(interior)
        frames = []
        # axis-j strips span the interior range on axes < j and the full
        # range on axes > j; each cell of region \ interior covered once
        for j, ((a, b), (ia, ib)) in enumerate(zip(it.region, interior)):
            for lo, hi in ((a, ia), (ib, b)):
                if hi <= lo:
                    continue
                reg = [interior[k] for k in range(j)] + [(lo, hi)] + \
                    [it.region[k] for k in range(j + 1, len(s))]
                f = _c(it)
                f.region = tuple(reg)
                frames.append(f)
        return inner, frames

    def _place_exchanges(self, pro, body, epi, sched):
        """Insert halo markers per the plan; split the body into
        interior/frame phases when the overlap scheme applies."""
        plan = self.plan

        if self._rows_of(plan.after_prologue):
            pro = pro + [ExchangeSync(self._rows_of(plan.after_prologue),
                                      self.exchange_row)]
        if self._rows_of(plan.epi):
            epi = [ExchangeSync(self._rows_of(plan.epi),
                                self.exchange_row)] + epi

        top_rows = self._rows_of(plan.top)
        self.top_rows = top_rows
        if not top_rows and not plan.mid:
            return pro, body, epi
        top_keys = {_canon_row(fn, tk, toff)
                    for fn, tk, toff, _ in top_rows}

        # overlap applies when all per-step exchanges sit in the top batch
        # and every dense eq precedes every sparse item (else a dense
        # interior could race a sparse scatter)
        overlap = plan.overlap_ok and not plan.mid and top_rows
        if overlap:
            seen_sparse = False
            for it in body:
                if isinstance(it, LoweredSparse):
                    seen_sparse = True
                elif isinstance(it, LoweredEq) and seen_sparse:
                    overlap = False
                    break
        if overlap:
            shrinks = self._split_shrinks(body, top_keys)
            inners, tails = [], []
            for it in body:
                if isinstance(it, LoweredEq):
                    inner, frames = self._split_eq(it, shrinks[id(it)])
                    if inner is None:
                        overlap = False
                        break
                    inners.append(inner)
                    tails.extend(frames)
                else:
                    tails.append(it)
            if overlap:
                log_perf("explicit halo: overlap scheme (interior/frame "
                         "split, top-of-step exchange batch)")
                return (pro,
                        [ExchangeStart(top_rows, self.refresh_row)]
                        + inners
                        + [ExchangeFinish(top_rows, self.finish_rows)]
                        + tails,
                        epi)

        # synchronous: one batch at the top of the step plus any mid-step
        # markers the ghost-zone budget could not cover
        log_perf("explicit halo: synchronous per-step exchange"
                 + (" with mid-step refreshes" if plan.mid else ""))
        new_body = []
        if top_rows:
            new_body.append(ExchangeSync(top_rows, self.exchange_row))
        for i, it in enumerate(body):
            mrows = self._rows_of(plan.mid.get(i, {}))
            if mrows:
                new_body.append(ExchangeSync(mrows, self.exchange_row))
            new_body.append(it)
        return pro, new_body, epi

    # -- the exchange ------------------------------------------------------

    def _row_index(self, fn, tk, toff, t, params):
        from ..compiler.executor import step_row, save_row, factor_value
        if tk == 'stepping':
            return step_row(t, toff, fn._time_size)
        if tk == 'save':
            return save_row(t, toff, params, fn)
        if tk == 'cond':
            return t // factor_value(fn.dimensions[0].factor, params) + toff
        return None

    def _rows(self, sbufs, sparams, t, fn, tk, toff):
        """Each shard's row of ``fn`` at (tk, toff), or its whole tensor
        (a function without a time axis)."""
        ri = self._row_index(fn, tk, toff, t, sparams[0])
        rows = [b[fn.name] for b in sbufs]
        return rows if ri is None else [r[ri] for r in rows]

    def _exchange_axis(self, rows, ax, width, dn, hl):
        """Refresh the ``width``-wide halo slabs of ``rows`` (one tensor a
        shard) along axis ``ax`` (dimension ``dn``) from the neighbours:
        the right edge of each shard into its right neighbour's left halo,
        the left edge into its left neighbour's right halo. The outermost
        shards' outer slabs stay as they are: zero from the pad, since
        every shard's writes stay inside the global domain."""
        lext = self.parts[dn][2]
        for line in self._lines[dn]:
            for a, b in zip(line, line[1:]):
                for dst, src in (
                        (_slab(rows[b], ax, hl - width, hl),
                         _slab(rows[a], ax, hl + lext - width, hl + lext)),
                        (_slab(rows[a], ax, hl + lext, hl + lext + width),
                         _slab(rows[b], ax, hl, hl + width))):
                    dst.copy_(src)
                    self.exchange['copies'] += 1
                    self.exchange['bytes'] += src.numel() * \
                        src.element_size()

    def _refresh(self, rows, fn, margins, lead=0):
        """Sequential per-axis exchange: each later axis's slabs include
        the halos the earlier axes refreshed, so the corners compose (the
        reference's diagonal-free schemes)."""
        for j, d in enumerate(fn.space_dimensions):
            w = margins[j]
            if d.name not in self.parts or w == 0:
                continue
            self._exchange_axis(rows, lead + j, w, d.name, fn.halo[j][0])

    def exchange_row(self, sbufs, sparams, t, fn, tk, toff, margins):
        """Refresh ``fn``'s row at (tk, toff) on the compute stream."""
        rows = self._rows(sbufs, sparams, t, fn, tk, toff)
        lead = rows[0].dim() - len(fn.space_dimensions)
        self._refresh(rows, fn, margins, lead=lead)

    def _side(self):
        """The side stream of the shards' one CUDA device, or None (the CPU,
        or shards on several devices: their copies run on the compute
        streams)."""
        devs = {sh.device for sh in self.shards}
        if len(devs) != 1:
            return None
        dev = next(iter(devs))
        if dev.type != 'cuda':
            return None
        side = self._cuda_side.get(dev)
        if side is None:
            side = self._cuda_side[dev] = torch.cuda.Stream(device=dev)
        return side

    def refresh_row(self, sbufs, sparams, t, fn, tk, toff, margins):
        """``ExchangeStart``: refresh ``fn``'s row, on the side stream after
        the compute stream's work so far where there is one."""
        side = self._side()
        if side is None:
            return self.exchange_row(sbufs, sparams, t, fn, tk, toff,
                                     margins)
        side.wait_stream(torch.cuda.current_stream(side.device))
        with torch.cuda.stream(side):
            self.exchange_row(sbufs, sparams, t, fn, tk, toff, margins)

    def finish_rows(self):
        """``ExchangeFinish``: the compute stream waits for the side
        stream's copies."""
        side = self._side()
        if side is not None:
            torch.cuda.current_stream(side.device).wait_stream(side)

    def synchronize(self):
        """Wait for the shards' work on every CUDA device when they span
        several (on one device the compute stream orders it all)."""
        devs = {sh.device for sh in self.shards if sh.device.type == 'cuda'}
        if len(devs) > 1:
            for d in devs:
                torch.cuda.synchronize(d)

    def step_slabs(self, sbufs):
        """(copies, bytes) of one top-of-step batch, from the plan's rows
        and the shards' tensors: 2 (shards - 1) slabs a line of shards
        along each exchanged axis, each ``width`` planes of the row's local
        halo'd extent on the other axes."""
        copies = nbytes = 0
        for fn, tk, toff, margins in self.top_rows:
            buf = sbufs[0][fn.name]
            shape = buf.shape[1:] if tk is not None else buf.shape
            lead = len(shape) - len(fn.space_dimensions)
            for j, d in enumerate(fn.space_dimensions):
                if d.name not in self.parts or not margins[j]:
                    continue
                n = sum(2 * (len(line) - 1) for line in self._lines[d.name])
                slab = margins[j] * int(np.prod(shape)) // shape[lead + j]
                copies += n
                nbytes += n * slab * buf.element_size()
        return copies, nbytes

    # -- cutting and joining the shards ------------------------------------

    def _replicated(self, fn):
        return fn is None or fn.is_SparseFunction or fn.grid is None

    def local_space(self, fn):
        """A shard's halo'd extent per space axis of ``fn``
        (``local_space``)."""
        return local_space(fn, self.parts)

    def _cut(self, fn, arr, sh):
        """Shard ``sh``'s local tensor of ``fn`` from ``arr``, its whole
        tensor (a window of save rows under streaming): the shard's part of
        the interior on partitioned axes, the whole halo'd extent on the
        others; dead cells zero, or edge values for an 'edge' function."""
        lead = arr.dim() - len(fn.space_dimensions)
        local = torch.zeros(tuple(arr.shape[:lead]) + self.local_space(fn),
                            dtype=arr.dtype, device=sh.device)
        edge = getattr(fn, 'halo_state', 'zero') == 'edge'
        src, dst = arr, local
        for j, (d, n, (hl, hr)) in enumerate(zip(
                fn.space_dimensions, type(fn)._space_shape, fn.halo)):
            ax = lead + j
            part = self.parts.get(d.name)
            if part is None:
                src = src.narrow(ax, 0, hl + n + hr)
                dst = dst.narrow(ax, 0, hl + n + hr)
                continue
            lext = part[2]
            off, live = sh.offsets[d.name], sh.live[d.name]
            if edge and live < lext:
                ix = torch.clamp(torch.arange(lext) + off, max=n - 1) + hl
                src = src.index_select(ax, ix.to(src.device))
                dst = dst.narrow(ax, hl, lext)
            else:
                src = src.narrow(ax, hl + off, live)
                dst = dst.narrow(ax, hl, live)
        if dst.numel():
            dst.copy_(src)
        return local

    def _pad_static(self, fn, locals_):
        """Fill the halos of a row the plan marks static (a parameter, a
        tap-read save buffer) once, at the cut: the exchange over the whole
        tensor, then for an 'edge' function edge values on the outermost
        shards' outer slabs (devito_tpu's ``_pad_local``)."""
        needed = None
        for (name, tk, toff), margins in self.plan.static.items():
            if name == fn.name:
                needed = list(margins) if needed is None else \
                    [max(a, b) for a, b in zip(needed, margins)]
        if needed is None:
            return
        lead = locals_[0].dim() - len(fn.space_dimensions)
        edge = getattr(fn, 'halo_state', 'zero') == 'edge'
        for j, d in enumerate(fn.space_dimensions):
            if d.name not in self.parts:
                continue
            hl, hr = fn.halo[j]
            if needed[j]:
                self._exchange_axis(locals_, lead + j, needed[j], d.name, hl)
            if edge:
                self._edge_replicate(locals_, lead + j, d.name, hl, hr)

    def _edge_replicate(self, rows, ax, dn, hl, hr):
        """The outermost shards' outer halo slabs take edge values, as
        ``pad_outer_halo`` gives the whole tensor (reference:
        initialize_function's pad mode)."""
        lext = self.parts[dn][2]
        for line in self._lines[dn]:
            first, last = rows[line[0]], rows[line[-1]]
            if hl:
                _slab(first, ax, 0, hl).copy_(
                    _slab(first, ax, hl, hl + 1).expand_as(
                        _slab(first, ax, 0, hl)))
            if hr:
                _slab(last, ax, hl + lext, hl + lext + hr).copy_(
                    _slab(last, ax, hl + lext - 1, hl + lext).expand_as(
                        _slab(last, ax, hl + lext, hl + lext + hr)))

    def convert(self, name, arr):
        """One whole tensor -> one tensor a shard (also each chunk's window
        of save rows under streaming). A replicated tensor (sparse data and
        coordinates, functions without a grid) is copied to every shard;
        the first shard's copy is the tensor itself where it shares its
        device."""
        fn = self.op._reads.get(name)
        if self._replicated(fn):
            return [arr if sh.index == 0 and sh.device == arr.device
                    else arr.to(sh.device, copy=True) for sh in self.shards]
        locals_ = [self._cut(fn, arr, sh) for sh in self.shards]
        self._pad_static(fn, locals_)
        return locals_

    def prepare_buffers(self, bufs):
        """The whole tensors of an apply (``Operator._prepare``) -> one dict
        of tensors a shard, with each sparse function's owner bucket
        (``<name>_own``, a shard's owned point indices; devito_tpu's
        ``bucket_sparse_points`` from the coordinates) and without the
        separable geometry (the shards gather, as devito_tpu's do)."""
        sbufs = [{} for _ in self.shards]
        for name, arr in bufs.items():
            if name.endswith('_sep') and name[:-4] in self.op._sparse:
                continue
            for b, t in zip(sbufs, self.convert(name, arr)):
                b[name] = t
        for name, sf in self.op._sparse.items():
            coords = bufs.get(f'{name}_coords')
            interp = getattr(sf, 'interpolator', None)
            if coords is None or interp is None or getattr(
                    interp, 'name', '') in ('precomputed', 'matrix'):
                continue  # gridpoint tables: replicated, corners masked
            buckets = bucket_sparse_points(
                coords.cpu().numpy(), self.grid, self.dist.topology,
                int(interp.max_radius) + 1)
            for sh, b in zip(self.shards, sbufs):
                own = buckets[sh.coords]
                b[f'{name}_own'] = torch.as_tensor(
                    own[own >= 0].astype(np.int64), device=sh.device)
        step = self.step_slabs(sbufs)
        self.exchange.update(step_copies=step[0], step_bytes=step[1])
        return sbufs

    def restore(self, name, locals_, arr):
        """Write the shards' tensors of ``name`` back into ``arr``, its
        whole tensor (or a window of save rows), in place: each shard's live
        interior into its part of the domain; a replicated function from
        the first shard."""
        fn = self.op._reads[name]
        if self._replicated(fn):
            if locals_[0] is not arr:
                arr.copy_(locals_[0])
            return arr
        lead = arr.dim() - len(fn.space_dimensions)
        for sh, loc in zip(self.shards, locals_):
            src, dst = loc, arr
            for j, (d, n, (hl, hr)) in enumerate(zip(
                    fn.space_dimensions, type(fn)._space_shape, fn.halo)):
                ax = lead + j
                if d.name in self.parts:
                    live = sh.live[d.name]
                    src = src.narrow(ax, hl, live)
                    dst = dst.narrow(ax, hl + sh.offsets[d.name], live)
                else:
                    src = src.narrow(ax, hl, n)
                    dst = dst.narrow(ax, hl, n)
            if dst.numel():
                dst.copy_(src)
        return arr
