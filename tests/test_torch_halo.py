"""The explicit halo path of devito_tpu_torch (parallel/halo.py) against
devito_tpu's (tests/test_halo.py's cases).

Both packages get the same numpy inputs; devito_tpu runs on its 8 virtual
CPU devices (conftest), the port on shards on 'cpu'. Stated tolerances:
fp64 rtol 1e-10 (x max) for wavefields and receivers against devito_tpu;
the port's sharded run bit-equal to its own unsharded run where no sum
crosses shards; the halo scheme, the halo plan's tables and the local
schedule item for item equal devito_tpu's. In place of devito_tpu's HLO
tests: the exchange moves exactly the plan's slabs a step and never a
whole interior, and the interior updates read no halo.
"""

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu.parallel import halo as hj  # noqa: E402
from devito_tpu.parallel.distributor import Distributor as DistJ  # noqa
from devito_tpu_torch.parallel import halo as ht  # noqa: E402
from devito_tpu_torch.parallel.distributor import Distributor as DistT  # noqa

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

#: Port against devito_tpu over a whole run, fp64
TOL = 1e-10


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def mkgrid(pkg, shape, topology=None, dtype=np.float64):
    grid = pkg.Grid(shape=shape, extent=tuple(float(s - 1) for s in shape),
                    dtype=dtype)
    if topology is not None:
        n = int(np.prod(topology))
        if pkg is dj:
            grid._distributor = DistJ(grid, topology=topology,
                                      devices=jax.devices()[:n])
        else:
            grid._distributor = DistT(grid, topology=topology,
                                      devices=[torch.device('cpu')] * n)
    return grid


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


# -- the problems (tests/test_halo.py's), one builder for both packages -------

def acoustic(pkg, grid, nt=8, so=4, dt_=0.04):
    u = pkg.TimeFunction(name='u', grid=grid, time_order=2, space_order=so)
    vp = pkg.Function(name='vp', grid=grid)
    vp.data[:] = 1.5
    st = pkg.solve((1 / (vp * vp)) * u.dt2 - u.laplace, u.forward)
    u.data[(0,) + tuple(s // 2 for s in grid.shape)] = 1.0
    op = pkg.Operator(pkg.Eq(u.forward, st), subs=grid.spacing_map)
    return op, dict(time_M=nt - 1, dt=dt_), [u]


def src_rec(pkg, grid, nt=6):
    u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
    src = pkg.SparseTimeFunction(name='src', grid=grid, npoint=2, nt=nt,
                                 coordinates=[[11., 11.], [5.5, 17.2]])
    src.data[:] = 1.0
    rec = pkg.SparseTimeFunction(name='rec', grid=grid, npoint=3, nt=nt,
                                 coordinates=[[11., 11.], [6., 17.],
                                              [20., 3.]])
    op = pkg.Operator([pkg.Eq(u.forward, 0.5 * u + 0.1 * u.dx),
                       src.inject(field=u.forward, expr=src),
                       rec.interpolate(expr=u)])
    return op, dict(time_M=nt - 2, dt=1.0), [u, rec]


def edge_param(pkg, grid):
    u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
    b = pkg.Function(name='b', grid=grid, space_order=2)
    n = grid.shape
    b.data[:] = np.arange(n[0] * n[1], dtype=np.float64).reshape(n)
    b.pad_outer_halo()
    op = pkg.Operator(pkg.Eq(u.forward, 0.5 * u + b.dx))
    return op, dict(time_M=3, dt=1.0, h_x=1.0, h_y=1.0), [u]


def subdomain(pkg, grid):
    u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
    u.data[0, 8, 8] = 1.0
    op = pkg.Operator(pkg.Eq(u.forward, 0.5 * u + 0.1 * u.laplace,
                             subdomain=grid.interior), subs=grid.spacing_map)
    return op, dict(time_M=4, dt=0.1), [u]


def backward(pkg, grid):
    v = pkg.TimeFunction(name='v', grid=grid, time_order=2, space_order=4)
    vp = pkg.Function(name='vp', grid=grid)
    vp.data[:] = 1.2
    v.data[2, 12, 12] = 1.0
    st = pkg.solve((1 / (vp * vp)) * v.dt2 - v.laplace, v.backward)
    op = pkg.Operator(pkg.Eq(v.backward, st), subs=grid.spacing_map)
    return op, dict(time_m=1, time_M=6, dt=0.04), [v]


def ghost_chain(pkg, grid, boundary=False):
    u = pkg.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    tmp = pkg.Function(name='tmp', grid=grid, space_order=4)
    u.data[0, 16, 16] = 1.0
    if boundary:
        # a pulse at the global boundary: the outermost shards' ghost
        # zones must stay inside the domain
        u.data[0, 2, 30] = 1.0
    op = pkg.Operator([pkg.Eq(tmp, u.dx),
                       pkg.Eq(u.forward, 0.5 * u + 0.1 * tmp.dx)],
                      subs=grid.spacing_map)
    return op, dict(time_M=5, dt=0.04), [u, tmp]


def save_tap(pkg, grid, nt=6):
    us = pkg.TimeFunction(name='us', grid=grid, space_order=4, save=nt)
    v = pkg.TimeFunction(name='v', grid=grid, time_order=2, space_order=4)
    us.data[:] = np.random.RandomState(7).rand(nt, *grid.shape)
    op = pkg.Operator(pkg.Eq(v.forward, 0.3 * v + us.dx2),
                      subs=grid.spacing_map)
    return op, dict(time_M=nt - 2, dt=0.04), [v]


def reductions(pkg, grid):
    u = pkg.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    vp = pkg.Function(name='vp', grid=grid)
    vp.data[:] = 1.5
    s = pkg.Function(name='s', shape=(1,), dimensions=(pkg.Dimension('i0'),),
                     dtype=np.float64)
    mx = pkg.Function(name='mx', shape=(1,),
                      dimensions=(pkg.Dimension('i1'),), dtype=np.float64)
    st = pkg.solve((1 / (vp * vp)) * u.dt2 - u.laplace, u.forward)
    u.data[(0,) + tuple(c // 2 for c in grid.shape)] = 1.0
    op = pkg.Operator([pkg.Eq(u.forward, st), pkg.Inc(s, u * u),
                       pkg.ReduceMax(mx, u)], subs=grid.spacing_map)
    return op, dict(time_M=6, dt=0.04), [u, s, mx]


def inf_dead_pad(pkg, grid):
    f = pkg.Function(name='f', grid=grid)
    f.data[:] = 2.0
    s = pkg.Function(name='s', shape=(1,), dimensions=(pkg.Dimension('i0'),),
                     dtype=np.float64)
    return pkg.Operator([pkg.Inc(s, 1 / f)]), {}, [s]


def matrix_sparse(pkg, grid):
    from importlib import import_module
    msf = import_module(pkg.__name__ + '.types.sparse').MatrixSparseTimeFunction
    x, y = grid.dimensions
    u = pkg.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    vp = pkg.Function(name='vp', grid=grid)
    vp.data[:] = 1.5
    M = np.array([[1.0], [-1.0]])
    src = msf(name='src', grid=grid, npoint=1, nt=8, matrix=M, r=2,
              gridpoints=[[7, 9], [22, 20]])
    src.interpolation_coefficients[x][:] = [[1.0, 0.0], [0.5, 0.5]]
    src.interpolation_coefficients[y][:] = [[1.0, 0.0], [1.0, 0.0]]
    src.data[:] = 1.0
    src.manual_scatter()
    rec = msf(name='rec', grid=grid, npoint=1, nt=8, matrix=M.copy(), r=2,
              gridpoints=[[9, 9], [20, 22]])
    rec.interpolation_coefficients[x][:] = [[1.0, 0.0], [0.5, 0.5]]
    rec.interpolation_coefficients[y][:] = [[1.0, 0.0], [1.0, 0.0]]
    st = pkg.solve((1 / (vp * vp)) * u.dt2 - u.laplace, u.forward)
    op = pkg.Operator([pkg.Eq(u.forward, st),
                       src.inject(field=u.forward, expr=src),
                       rec.interpolate(expr=u)], subs=grid.spacing_map)
    return op, dict(time_M=6, dt=0.04), [u, rec]


PROBLEMS = {
    'acoustic': (acoustic, (32, 32), (2, 2)),
    'src_rec': (src_rec, (24, 24), (2, 2)),
    'edge_param': (edge_param, (16, 16), (2, 2)),
    'subdomain': (subdomain, (16, 16), (2, 2)),
    'backward': (backward, (24, 24), (2, 2)),
    'ghost_chain': (ghost_chain, (32, 32), (2, 2)),
    'save_tap': (save_tap, (24, 24), (2, 2)),
    'reductions': (reductions, (32, 32), (4, 2)),
    'inf_dead_pad': (inf_dead_pad, (29, 27), (4, 2)),
    'matrix_sparse': (matrix_sparse, (32, 32), (4, 2)),
}


def build(pkg, name, topology='default'):
    fn, shape, topo = PROBLEMS[name]
    grid = mkgrid(pkg, shape, topo if topology == 'default' else topology)
    return fn(pkg, grid)


def run(pkg, name, topology='default'):
    op, args, outs = build(pkg, name, topology)
    op.apply(**args)
    return op, [np.array(f.data) for f in outs]


# -- the analysis --------------------------------------------------------------

def test_halo_scheme_analysis():
    grid = mkgrid(dt, (16, 16))
    u = dt.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    vp = dt.Function(name='vp', grid=grid, space_order=4)
    st = dt.solve((1 / (vp * vp)) * u.dt2 - u.laplace, u.forward)
    op = dt.Operator(dt.Eq(u.forward, st), subs=grid.spacing_map)
    needs = ht.halo_scheme(op._schedule)
    assert needs[('u', 'stepping', 0)] == [2, 2]
    assert ('vp', None, None) not in needs


def _keyed(table):
    return {(n, tk, str(toff)): list(m) for (n, tk, toff), m in table.items()}


def plan_tables(op, halo):
    plan = halo.plan_halos(op._schedule, op._reads)
    body = op._schedule.body
    ext = {i: list(plan.ext[id(it)]) for i, it in enumerate(body)
           if id(it) in plan.ext}
    return dict(static=_keyed(plan.static),
                after_prologue=_keyed(plan.after_prologue),
                top=_keyed(plan.top), epi=_keyed(plan.epi), ext=ext,
                mid={i: _keyed(t) for i, t in plan.mid.items()},
                overlap_ok=plan.overlap_ok,
                scheme=_keyed(halo.halo_scheme(op._schedule)))


@pytest.mark.parametrize('name', sorted(PROBLEMS))
def test_halo_plan_tables_equal_devito_tpu(name):
    got = plan_tables(build(dt, name)[0], ht)
    want = plan_tables(build(dj, name)[0], hj)
    assert got == want


def item_sig(it):
    if getattr(it, 'kind', None) == 'halo':
        return (type(it).__name__, sorted(
            (fn.name, tk, str(toff), list(m)) for fn, tk, toff, m in it.rows))
    if hasattr(it, 'region'):
        return ('eq', it.target.name, it.time_kind, str(it.time_off),
                tuple(it.region), str(it.condition), it.increment,
                it.reduction)
    return ('sparse', it.kind, it.sparse.name)


def local_schedule(op):
    sched = op._halo_runner_for().local_schedule
    return [[item_sig(it) for it in items]
            for items in (sched.prologue, sched.body, sched.epilogue)]


@pytest.mark.parametrize('name', sorted(PROBLEMS))
def test_local_schedule_equals_devito_tpu(name):
    """Every problem takes the explicit path in both packages, and the
    local schedules (localized regions and masks, ghost zones, the
    interior/frame split, the markers and their rows) are equal, item for
    item."""
    got = local_schedule(build(dt, name)[0])
    want = local_schedule(build(dj, name)[0])
    assert got == want


def test_overlap_schedule_structure():
    """[ExchangeStart, interior, ExchangeFinish, 4 frames]; the onion frames
    cover region minus interior exactly once (tests/test_halo.py)."""
    op = build(dt, 'acoustic')[0]
    body = op._halo_runner_for().local_schedule.body
    assert isinstance(body[0], ht.ExchangeStart)
    assert body[1].region == ((2, 14), (2, 14))
    assert isinstance(body[2], ht.ExchangeFinish)
    cells = set()
    for f in body[3:]:
        (xa, xb), (ya, yb) = f.region
        for i in range(xa, xb):
            for j in range(ya, yb):
                assert (i, j) not in cells
                cells.add((i, j))
    assert len(body[3:]) == 4 and len(cells) == 16 * 16 - 12 * 12


# -- the runs ------------------------------------------------------------------

@pytest.mark.parametrize('topology', [(4, 2), (2, 2), (8, 1), (1, 8)])
def test_explicit_halo_matches_devito_tpu_2d(topology):
    _, (ref,) = run(dt, 'acoustic', None)
    op, (got,) = run(dt, 'acoustic', topology)
    assert op._halo_runner is not None
    assert np.array_equal(got, ref)
    opj, (want,) = run(dj, 'acoustic', topology)
    assert opj._halo_runner is not None
    close(got, want)


def test_explicit_halo_matches_devito_tpu_3d():
    def go(pkg, topo):
        op, args, (u,) = acoustic(pkg, mkgrid(pkg, (16, 16, 16), topo))
        op.apply(**args)
        return op, np.array(u.data)
    _, ref = go(dt, None)
    op, got = go(dt, (2, 2, 2))
    assert op._halo_runner is not None
    assert np.array_equal(got, ref)
    close(got, go(dj, (2, 2, 2))[1])


@pytest.mark.parametrize('name', ['src_rec', 'edge_param', 'subdomain',
                                  'backward', 'ghost_chain', 'save_tap',
                                  'matrix_sparse'])
def test_problem_matches_serial_and_devito_tpu(name):
    """Each problem on the explicit path equals the port's unsharded run
    (to the bit for the fields; a receiver adds the shards' partial sums,
    so within fp64 round-off) and devito_tpu's sharded run within fp64
    rtol 1e-10; the ghost-zone chain devito_tpu's unsharded run (see
    test_ghost_zone_chain_at_the_boundary_matches_serial: the wave's tail
    reaches the boundary, where devito_tpu's sharded run departs from its
    unsharded one by 3.5e-9 x max here)."""
    _, ref = run(dt, name, None)
    op, got = run(dt, name)
    assert op._halo_runner is not None
    _, want = run(dj, name, None if name == 'ghost_chain' else 'default')
    records = 1 if name in ('src_rec', 'matrix_sparse') else 0
    for k, (g, r, w) in enumerate(zip(got, ref, want)):
        if k >= len(got) - records:
            close(g, r, 1e-14)
        else:
            assert np.array_equal(g, r)
        close(g, w)


def test_ghost_zone_chain_at_the_boundary_matches_serial():
    """A same-step chain (tmp = u.dx read with taps by u's update) runs with
    ghost zones; with a pulse at the global boundary the port's sharded run
    is bit-equal to its unsharded one and matches devito_tpu's unsharded
    run, as each shard's ghost-extended region is clamped to the global
    domain. devito_tpu's own sharded run differs from its unsharded run
    there (its outermost shards compute their ghost zones into the
    global halo, which its unsharded run leaves zero): a limit of the
    reference, pinned here so that a change to it shows."""
    def go(pkg, topo):
        op, args, outs = ghost_chain(pkg, mkgrid(pkg, (32, 32), topo),
                                     boundary=True)
        op.apply(**args)
        return op, [np.array(f.data) for f in outs]
    _, ref = go(dt, None)
    op, got = go(dt, (2, 2))
    assert op._halo_runner is not None
    _, serial_j = go(dj, None)
    _, sharded_j = go(dj, (2, 2))
    for g, r, w, wj in zip(got, ref, serial_j, sharded_j):
        assert np.array_equal(g, r)
        close(g, w)
        assert np.abs(wj - w).max() > 1e-3 * np.abs(w).max()


def test_errctl_on_explicit_path():
    """errctl='max' halts every shard when one shard's check fails
    (devito_tpu: the psum-ed halt flag)."""
    for pkg in (dt, dj):
        grid = mkgrid(pkg, (16, 16), (2, 2), np.float32)
        u = pkg.TimeFunction(name='u', grid=grid, time_order=2,
                             space_order=2)
        vp = pkg.Function(name='vp', grid=grid)
        vp.data[:] = 1.5
        u.data[0, 8, 8] = 1.0
        st = pkg.solve((1 / (vp * vp)) * u.dt2 - u.laplace, u.forward)
        op = pkg.Operator(pkg.Eq(u.forward, st), subs=grid.spacing_map,
                          opt=('advanced', {'errctl': 'max'}))
        assert op._halo_runner_for() is not None
        with pytest.raises(pkg.ExecutionError):
            op.apply(time_M=400, dt=10.0)


def test_reductions_match_serial_and_devito_tpu():
    """Inc contraction and ReduceMax over (4, 2) shards: the shards'
    partials combine (devito_tpu: psum, pmax)."""
    _, (u0, s0, m0) = run(dt, 'reductions', None)
    op, (u1, s1, m1) = run(dt, 'reductions')
    assert op._halo_runner is not None
    assert np.array_equal(u1, u0)
    close(s1, s0, 1e-13)
    assert np.array_equal(m1, m0)
    _, (uj, sj, mj) = run(dj, 'reductions')
    close(u1, uj)
    close(s1, sj)
    close(m1, mj)


def test_uneven_sum_reduction_inf_in_dead_pad():
    """29 x 27 over (4, 2): the last shards' dead cells evaluate 1/f = inf;
    the mask keeps them out of the combined sum."""
    _, (s0,) = run(dt, 'inf_dead_pad', None)
    op, (s1,) = run(dt, 'inf_dead_pad')
    assert op._halo_runner is not None
    assert np.isfinite(s1).all()
    close(s1, s0, 1e-14)
    close(s1, run(dj, 'inf_dead_pad')[1][0])


# -- the exchange ----------------------------------------------------------------

def test_exchange_moves_the_plans_slabs_and_never_an_interior():
    """devito_tpu's HLO tests (no all-gather; the interior consumes no
    permute) in terms of what the port does: each step the exchange copies
    exactly the top batch's slabs, 2 (shards - 1) a line of shards an
    axis, each the row's margin times its local halo'd extent on the other
    axes, and the interior updates read no halo."""
    topology = (2, 2)
    op, args, (u,) = acoustic(dt, mkgrid(dt, (32, 32), topology))
    op.apply(**args)
    hr = op._halo_runner
    (fn, tk, toff, margins), = hr.top_rows
    assert (fn.name, tk, margins) == ('u', 'stepping', [2, 2])
    local = (4 + 16 + 4, 128)        # x: halo + 16 + halo; y rounded to 128
    slabs = 2 * (2 - 1) * 2          # lines of 2 shards, 2 lines, per axis
    step_bytes = slabs * 2 * 128 * 8 + slabs * 2 * local[0] * 8
    assert hr.exchange['step_copies'] == 2 * slabs
    assert hr.exchange['step_bytes'] == step_bytes
    steps = args['time_M'] - op._default_time_bounds()[0] + 1
    assert op.last_exchange == {'copies': steps * 2 * slabs,
                                'bytes': steps * step_bytes}
    interior = 16 * 16 * 8
    assert step_bytes // (2 * slabs) < interior
    inner = hr.local_schedule.body[1]
    (xa, xb), (ya, yb) = inner.region
    assert xa >= margins[0] and 16 - xb >= margins[0]
    assert ya >= margins[1] and 16 - yb >= margins[1]


def test_kernel_plans_take_the_shards_layout():
    """Each shard-local dense item is planned for the shards' local layout
    and every shard runs it (the CPU runs its plain version)."""
    op, args, _ = acoustic(dt, mkgrid(dt, (32, 32), (2, 2)))
    hr = op._halo_runner_for()
    run_ = hr.runner
    assert {sh for sh, *_ in run_.shard_plans} == {0, 1, 2, 3}
    for _, it, eq, plan in run_.shard_plans:
        assert plan is not None
        assert plan.space(eq.target) == hr.local_space(eq.target) == (24, 128)


# -- the gathered path and the configuration ------------------------------------

def test_ineligible_schedule_runs_gathered_under_auto():
    """A tap-read function whose halo the user wrote (data_with_halo) is
    ineligible: under 'auto' the operator runs gathered, with its reason
    kept and the apply counted, and equals the unsharded run; under
    'explicit' the same schedule raises InvalidArgument."""
    def go(topo, mode='auto'):
        grid = mkgrid(dt, (16, 16), topo)
        u = dt.TimeFunction(name='u', grid=grid, space_order=2)
        b = dt.Function(name='b', grid=grid, space_order=2)
        b.data_with_halo[:] = np.arange(20 * 20.).reshape(20, 20)
        op = dt.Operator(dt.Eq(u.forward, 0.5 * u + b.dx))
        with dt.switchconfig(halo=mode):
            op.apply(time_M=3, dt=1.0, h_x=1.0, h_y=1.0)
        return op, np.array(u.data)
    _, ref = go(None)
    op, got = go((2, 2))
    assert op._halo_runner is None and "'dirty'" in op.halo_decline
    assert op.gathered_applies == 1
    assert np.array_equal(got, ref)
    with pytest.raises(dt.InvalidArgument, match='not eligible'):
        go((2, 2), 'explicit')


def test_gspmd_raises_with_its_replacement():
    with pytest.raises(dt.InvalidArgument, match='Do not port'):
        dt.configuration['halo'] = 'gspmd'
    with pytest.raises(dt.InvalidArgument, match="halo='auto'"):
        with dt.switchconfig(halo='gspmd'):
            pass
    assert dt.configuration['halo'] == 'auto'
