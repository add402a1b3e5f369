"""K1's fused units (kernels/stencil.py ``plan_run``): a run of consecutive,
mutually independent equations of a time loop's body that each take the
point design shares one unit, launched once a step, that reads each access
group they share once. Built from the benchmark's small configurations
(``gpubench/tests/configs/*-tiny.json``) through the port, and from small
operators for the cases that must stay apart."""

import importlib

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu_torch.compiler import executor as E
from devito_tpu_torch.kernels import _nvcc, stencil as K
from gpubench import generator, units
from gpubench.manifest import Manifest
from gpubench.tests.helpers import SEED, tiny

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _program(problem, dtype=None):
    """The survey program of ``problem``'s small configuration, built."""
    cfg = tiny(problem)
    if dtype is not None:
        cfg = dict(cfg, dtype=dtype)
    mod = importlib.import_module(f'gpubench.solvers.{problem}')
    prog = mod.Program(cfg, generator.model_fields(cfg, SEED),
                       generator.time_step(cfg), 0.010,
                       generator.receivers(cfg))
    prog.build()
    return prog


def _runs(op):
    """The targets of each K1 unit of ``op``'s time loop, in order: a
    fused unit's together."""
    plans = dict((id(eq), p) for eq, p in op.kernel_plans)
    out = []
    for it in op.schedule.body:
        p = plans.get(id(it)) if hasattr(it, 'region') else None
        if p is not None and p.eq is it:
            out.append([e.target.name for e in p.eqs])
    return out


def test_elastic_fuses_its_velocities_and_its_stresses():
    """The three velocities share a unit, CIRE's div(v) runs alone (it
    reads the velocities' new rows), and the six stresses, which read it,
    share another; each fused unit is named after its targets."""
    before = dict(K.fused)
    op = _program('elastic').solver.op_fwd(None)
    assert _runs(op) == [
        ['v_x', 'v_y', 'v_z'], ['cire0'],
        ['tau_xx', 'tau_xy', 'tau_xz', 'tau_yy', 'tau_yz', 'tau_zz']]
    assert {k: K.fused[k] - before[k] for k in before} == {
        'units': 2, 'equations': 9}
    vel = next(p for _, p in op.kernel_plans if p.eq.target.name == 'v_x')
    assert vel.design == 'point' and vel.nt == 3
    # 11 groups and 3 targets read and written, 21 rows apart
    assert len(vel.groups) == 11
    assert 'struct Point_v_x__v_y__v_z {' in vel.source
    assert 'constexpr int NT = 3;' in vel.source


def test_tti_fuses_u_with_v_and_cire0_with_cire1():
    op = _program('tti').solver.op_fwd(None)
    runs = _runs(op)
    assert ['cire0', 'cire1'] in runs and ['u', 'v'] in runs
    streamed = [p.eq.target.name for _, p in op.kernel_plans
                if p.design == 'stream']
    assert all([n] in runs for n in streamed)


def test_acoustic_keeps_its_unit():
    """The acoustic update streams alone: the plan its runner holds is the
    one ``plan_for`` makes, its key included, and its unit includes no
    header of the point design, so the fused units leave its key as it
    was."""
    op = _program('acoustic').solver.op_fwd(None)
    (eq, plan), = op.kernel_plans
    assert plan.design == 'stream' and plan.nt == 1 and plan.eqs == [eq]
    alone = K.plan_for(eq)
    assert alone.key == plan.key and alone.source == plan.source
    assert 'stencil.cuh' not in _nvcc.headers(plan.source)


def _grid3(shape=(10, 11, 12)):
    return dt.Grid(shape=shape, extent=tuple(float(n - 1) for n in shape))


def _pair(grid, so=2, second=None):
    """Two updates of u and v that share m and damp; ``second`` replaces
    v's right-hand side."""
    u = dt.TimeFunction(name='u', grid=grid, space_order=so)
    v = dt.TimeFunction(name='v', grid=grid, space_order=so)
    m = dt.Function(name='m', grid=grid, space_order=so)
    damp = dt.Function(name='damp', grid=grid, space_order=so)
    eqs = [dt.Eq(u.forward, damp * (u + m * u.dx)),
           dt.Eq(v.forward, second if second is not None else
                 damp * (v + m * v.dy))]
    return eqs, (u, v, m, damp)


def _targets(eqs, **kw):
    return _runs(dt.Operator(eqs, **kw))


def test_independent_pair_shares_a_unit():
    eqs, _ = _pair(_grid3())
    assert _targets(eqs) == [['u', 'v']]


def _apart(case):
    g = _grid3()
    if case == 'reads a written row':
        # v reads u's new row, which u's update writes
        eqs, (u, v, m, damp) = _pair(g)
        eqs[1] = dt.Eq(v.forward, damp * (v + m * u.forward))
        return eqs, [['u'], ['v']], {}
    if case == 'sparse item between':
        eqs, (u, v, m, damp) = _pair(g)
        src = dt.SparseTimeFunction(name='src', grid=g, npoint=1, nt=5,
                                    coordinates=np.array([[4., 5., 6.]]))
        return [eqs[0]] + src.inject(field=u.forward, expr=src) + \
            [eqs[1]], [['u'], ['v']], {}
    if case == 'different regions':
        eqs, (u, v, m, damp) = _pair(g)
        eqs[1] = dt.Eq(eqs[1].lhs, eqs[1].rhs, subdomain=g.interior)
        return eqs, [['u'], ['v']], {}
    if case == 'streamed member':
        # u's 3-D star of radius 4 streams; v takes the point design
        u = dt.TimeFunction(name='u', grid=g, time_order=2, space_order=8)
        v = dt.TimeFunction(name='v', grid=g, space_order=8)
        vp = dt.Function(name='vp', grid=g, space_order=8)
        return [dt.Eq(u.forward, dt.solve(u.dt2 - vp * u.laplace,
                                          u.forward)),
                dt.Eq(v.forward, v + vp * u)], [['u'], ['v']], {}
    if case == 'conditional write':
        # usave is written on every other step only
        eqs, (u, v, m, damp) = _pair(g)
        cd = dt.ConditionalDimension('cd', parent=g.time_dim, factor=2)
        usave = dt.TimeFunction(name='usave', grid=g, save=4, time_dim=cd,
                                space_order=2)
        return [eqs[0], dt.Eq(usave, damp * u + m)], [['u'], ['usave']], {}
    if case == 'no shared group':
        u = dt.TimeFunction(name='u', grid=g, space_order=2)
        v = dt.TimeFunction(name='v', grid=g, space_order=2)
        return [dt.Eq(u.forward, u + 1.), dt.Eq(v.forward, 2. * v)], \
            [['u'], ['v']], {}
    if case == 'arithmetic-bound member':
        # v's update makes many operations a byte of its rows
        eqs, (u, v, m, damp) = _pair(g)
        heavy = v
        for k in range(12):
            heavy = heavy + (k + 1.5) / (m + damp + k) * v.dy
        eqs[1] = dt.Eq(v.forward, heavy)
        return eqs, [['u'], ['v']], {}
    if case == 'too many groups':
        # each update reads m, damp and its own 8 functions: a union of 18
        fs = [dt.Function(name=f'f{k}', grid=g, space_order=2)
              for k in range(16)]
        eqs, (u, v, m, damp) = _pair(g)
        eqs = [dt.Eq(eqs[0].lhs, eqs[0].rhs + sum(fs[:8])),
               dt.Eq(eqs[1].lhs, eqs[1].rhs + sum(fs[8:]))]
        return eqs, [['u'], ['v']], {}
    raise ValueError(case)


@pytest.mark.parametrize('case', [
    'reads a written row', 'sparse item between', 'different regions',
    'streamed member', 'conditional write', 'no shared group',
    'arithmetic-bound member', 'too many groups'])
def test_equations_that_stay_apart(case):
    eqs, want, kw = _apart(case)
    op = dt.Operator(eqs, **kw)
    assert _runs(op) == want
    assert all(p.nt == 1 for _, p in op.kernel_plans if p is not None)


def _seeded(unit, dtype, gen):
    ins = [1 + torch.rand(g['fn']._allocated_space(), generator=gen,
                          dtype=dtype) for g in unit.groups]
    outs = [torch.rand(e.target._allocated_space(), generator=gen,
                       dtype=dtype) for e in unit.eqs]
    return outs, ins


def test_fused_plain_version_equals_its_members_in_fp64():
    """On seeded rows, a fused unit's plain version writes, bit for bit,
    what its equations' own plans write one by one."""
    op = _program('elastic', 'float64').solver.op_fwd(None)
    fused = list({id(p): p for _, p in op.kernel_plans
                  if p.nt > 1}.values())
    assert len(fused) == 2
    gen = torch.Generator().manual_seed(4)
    for unit in fused:
        assert unit.dtype == np.float64
        outs, ins = _seeded(unit, torch.float64, gen)
        rows = {g['key']: r for g, r in zip(unit.groups, ins)}
        got, want = [o.clone() for o in outs], [o.clone() for o in outs]
        params = {n: 0.37 for n in unit.param_names}
        K.stencil_update(unit, (got, ins), params)
        for e, w in zip(unit.eqs, want):
            p = K.plan_for(e)
            K.stencil_update(p, (w, [rows[g['key']] for g in p.groups]),
                             params)
        for g, w, o in zip(got, want, outs):
            assert torch.equal(g, w) and not torch.equal(g, o)


def test_fused_unit_takes_a_target_row_each():
    op = _program('elastic').solver.op_fwd(None)
    unit = next(p for _, p in op.kernel_plans if p.nt == 3)
    outs, ins = _seeded(unit, torch.float32, torch.Generator())
    with pytest.raises(ValueError, match='sequence of 3 target rows'):
        K.stencil_update(unit, (outs[0], ins), {'dt': 1.})
    with pytest.raises(ValueError, match='sequence of 3 target rows'):
        K.stencil_update(unit, (outs[:2], ins), {'dt': 1.})


def test_runner_launches_each_unit_once_a_step(monkeypatch):
    """The runner calls K1 once a step for each fused unit, at its first
    equation, and the elastic forward matches the run with every equation
    on its own unit."""
    calls = []
    real = E.stencil_update

    def counted(plan, rows, params):
        if plan.groups:     # not the zeroing of the shot's wavefields
            calls.append(tuple(e.target.name for e in plan.eqs))
        return real(plan, rows, params)

    def shot(fuse):
        if not fuse:
            monkeypatch.setattr(E, 'plan_run', lambda eqs, storage=None: [
                K.plan_for(eq, storage=storage) for eq in eqs])
        prog = _program('elastic', 'float64')
        monkeypatch.setattr(E, 'stencil_update', counted)
        calls.clear()
        rec = prog.shot(np.array([[60., 70., 10.]]))[0]
        monkeypatch.undo()
        return rec, list(calls), prog.nt - 1

    rec, fused_calls, steps = shot(True)
    unit = ('v_x', 'v_y', 'v_z')
    assert fused_calls.count(unit) == steps
    assert not any(c == ('v_y',) for c in fused_calls)
    # the prologue's three hoisted means of mu, then three units a step
    assert len(fused_calls) == 3 + 3 * steps
    plain, calls_apart, _ = shot(False)
    assert len(calls_apart) == 3 + 10 * steps
    np.testing.assert_array_equal(rec, plain)


def test_summary_keeps_a_section_for_each_equation():
    """A fused unit launches in its first equation's section; each other
    equation keeps its own, so the summary has a section a body item."""
    g = _grid3()
    eqs, (u, v, m, damp) = _pair(g)
    op = dt.Operator(eqs)
    assert _runs(op) == [['u', 'v']]
    summary = op.apply(time_M=3, dt=0.1)
    assert summary.labels == {'section0': 'u', 'section1': 'v'}


def test_unit_names_file_under_the_readers():
    """``gpubench/units.py`` files a fused unit's events by its struct,
    under the velocity and stress readers as their single units were."""
    def k1(point):
        return (f'void dtpu::stencil_kernel<float, float, 3, 11, 1, 3, '
                f'(anonymous namespace)::{point}>(x)')
    vel = 'Point_v_x__v_y__v_z'
    tau = 'Point_tau_xx__tau_xy__tau_xz__tau_yy__tau_yz__tau_zz'
    assert units.unit(k1(vel)) == 'v_x__v_y__v_z'
    assert units.unit(k1(tau)).startswith('tau_xx__')
    from types import SimpleNamespace
    from gpubench.tracefile import JOB_SPAN, Trace

    def x(name, a, b, cat='kernel'):
        return {'ph': 'X', 'cat': cat, 'name': name, 'pid': 1, 'tid': 1,
                'ts': a, 'dur': b - a}
    tr = Trace([x(JOB_SPAN, 0, 1000, 'user_annotation'),
                x(k1(vel), 10, 110), x(k1(tau), 120, 320),
                x(k1('Point_temporary'), 330, 360)])
    ctx = SimpleNamespace(trace=tr, traced_steps=1, bound=None)
    got = {n: Manifest.reader('per_layer', n)(ctx) for n in (
        'k1_velocity_ms_per_step', 'k1_stress_ms_per_step',
        'k1_temps_ms_per_step')}
    assert got == pytest.approx({'k1_velocity_ms_per_step': 0.1,
                                 'k1_stress_ms_per_step': 0.2,
                                 'k1_temps_ms_per_step': 0.03})


def test_chunks_follow_the_live_planes(monkeypatch):
    """A point unit runs in chunks of rows when the x planes its point
    reads keep live would fill more than LIVE_SHARE of the L2: at the
    small size none does; with an L2 of a few of its planes the fused
    units do, their equations' own units not."""
    op = _program('elastic').solver.op_fwd(None)
    plans = list({id(p): p for _, p in op.kernel_plans}.values())
    assert all(p.chunk_rows == 0 for p in plans)
    fused = [p for p in plans if p.nt > 1]
    plane = 4 * int(np.prod(fused[0].eq.target._allocated_space()[1:]))
    # 28 and 33 live planes fused; 13 at most alone
    monkeypatch.setattr(K, 'L2_BYTES', 30 * plane)
    for p in fused:
        assert K._chunk_rows(p) == K.POINT_CHUNK_ROWS
        assert all(K._chunk_rows(K.plan_for(e)) == 0 for e in p.eqs)
