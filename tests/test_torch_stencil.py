"""K1, the dense-stencil kernel module (devito_tpu_torch/kernels/stencil.py),
against the TPU kernel it ports (experiments/pallas_backend.py), which runs
here in Pallas interpret mode as tests/test_pallas_backend.py runs it.

On the CPU ``stencil_update`` runs the kernel's plain PyTorch version
(``stencil_update_reference``); the CUDA kernel itself is held against
that version by the ``cuda``-marked test below, on the card."""

import numpy as np
import pytest
import torch

import devito_tpu as dj
import devito_tpu_torch as dt
from devito_tpu.compiler.executor import _load_pallas
from devito_tpu.ir.lowering import lower_expressions as lower_j
from devito_tpu_torch.ir.lowering import lower_expressions as lower_t
from devito_tpu_torch.kernels import stencil as K

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _dense_items(sched):
    return [i for i in sched.all_items if getattr(i, 'kind', '') == 'dense']


def _acoustic_eq(pkg, shape, so, dtype, damped=True):
    g = pkg.Grid(shape=shape, extent=tuple(10. * (s - 1) for s in shape),
                 dtype=dtype)
    u = pkg.TimeFunction(name='u', grid=g, time_order=2, space_order=so)
    vp = pkg.Function(name='vp', grid=g, space_order=so)
    damp = pkg.Function(name='damp', grid=g, space_order=so)
    pde = (1 / (vp * vp)) * u.dt2 - u.laplace
    if damped:
        pde = pde + damp * u.dt
    return g, pkg.Eq(u.forward, pkg.solve(pde, u.forward))


def _equations(pkg):
    """(label, kernel takes it, equation) triples on which both
    packages' plans must agree."""
    g2 = pkg.Grid(shape=(12, 10), extent=(11., 9.))
    g1 = pkg.Grid(shape=(16,), extent=(15.,))
    u = pkg.TimeFunction(name='u', grid=g2, space_order=2)
    f = pkg.Function(name='f', grid=g2, space_order=2)
    u1 = pkg.TimeFunction(name='u1', grid=g1, space_order=2)
    x = g2.dimensions[0]
    cd = pkg.ConditionalDimension('cd', parent=g2.time_dim, factor=2)
    return [
        ('acoustic', True, _acoustic_eq(pkg, (9, 10, 11), 8,
                                        np.float32)[1]),
        ('diffusion', True, pkg.Eq(u.forward, pkg.solve(
            u.dt - u.laplace, u.forward))),
        ('increment', False, pkg.Inc(f, u)),
        ('condition', False, pkg.Eq(f, u + 1, implicit_dims=(cd,))),
        ('coordinates', False, pkg.Eq(u.forward, u + x)),
        ('1-D', False, pkg.Eq(u1.forward, u1 + u1.dx2)),
    ]


def test_plan_for_matches_reference():
    pb = _load_pallas()
    for (lab, want, ej), (_, _, et) in zip(_equations(dj), _equations(dt)):
        (ij,), (it,) = _dense_items(lower_j([ej])), _dense_items(lower_t([et]))
        got_j = pb.plan_for(ij, None) is not None
        got_t = K.plan_for(it) is not None
        assert (got_j, got_t) == (want, want), lab


def test_plan_for_declines_in_place_hazards():
    """The kernel writes its target row in place, so it declines what
    reads that row; the translator then runs the equation, and the
    operator still matches devito_tpu."""
    outs = []
    for pkg in (dj, dt):
        g = pkg.Grid(shape=(10, 12), extent=(9., 11.))
        f = pkg.Function(name='f', grid=g, space_order=2)
        v = pkg.TimeFunction(name='v', grid=g, time_order=1, space_order=2)
        f.data[:] = np.arange(120.).reshape(10, 12) / 100
        v.data[0] = np.arange(120.).reshape(10, 12) / 50
        eqs = [pkg.Eq(f, 2 * f + 1),
               pkg.Eq(v.forward, v.backward + v.dx)]   # t+1 and t-1 alias
        op = pkg.Operator(eqs)
        if pkg is dt:
            assert [p for _, p in op.kernel_plans] == [None, None]
        op.apply(time_M=2, dt=0.1)
        outs.append((np.array(f.data), np.array(v.data)))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('so', [2, 4, 8])
@pytest.mark.parametrize('shape', [(32, 32), (16, 24, 32), (13, 17, 19)])
def test_one_step_matches_pallas_kernel(shape, so, dtype):
    import jax.numpy as jnp
    pb = _load_pallas()
    gj, ej = _acoustic_eq(dj, shape, so, dtype)
    gt, et = _acoustic_eq(dt, shape, so, dtype)
    (ij,) = _dense_items(lower_j([ej], subs=gj.spacing_map))
    (it,) = _dense_items(lower_t([et], subs=gt.spacing_map))
    pj, pt = pb.plan_for(ij, None), K.plan_for(it)
    assert pj is not None and pt is not None
    assert pt.design == ('stream' if len(shape) == 3 else 'point')
    params = {'dt': 0.7}

    rng = np.random.default_rng(so)
    rows = {}
    for g in pt.groups:
        a = rng.standard_normal(g['fn']._allocated_space())
        if g['fn'].name == 'vp':
            a = 1.5 + np.abs(a)
        elif g['fn'].name == 'damp':
            a = 0.05 * np.abs(a)
        rows[g['key']] = a.astype(dtype)
    ref = np.asarray(pb.execute_plan(
        pj, [jnp.asarray(rows[(g['fn'].name, g['tk'], str(g['toff']))])
             for g in pj.groups], params, interpret=True))

    out = torch.zeros(it.target._allocated_space(),
                      dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
    ins = [torch.from_numpy(rows[g['key']]) for g in pt.groups]
    K.stencil_update(pt, (out, ins), params)
    got = out[tuple(slice(o, o + n)
                    for o, n in zip(pt.origins[0], pt.extents))].numpy()
    assert got.shape == ref.shape
    tol = (1e-5 if dtype == np.float32 else 1e-12) * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol


def _pallas_backend_op(pkg, shape):
    """The operator of tests/test_pallas_backend.py::test_pallas_matches_xla."""
    g = pkg.Grid(shape=shape, extent=tuple(float(s - 1) for s in shape))
    u = pkg.TimeFunction(name='u', grid=g, time_order=2, space_order=4)
    vp = pkg.Function(name='vp', grid=g)
    vp.data[:] = 1.5
    st = pkg.solve((1 / (vp * vp)) * u.dt2 - u.laplace, u.forward)
    u.data[(0,) + tuple(s // 2 for s in shape)] = 1.0
    return u, pkg.Operator(pkg.Eq(u.forward, st), subs=g.spacing_map)


@pytest.mark.parametrize('shape', [(32, 32), (16, 24, 32)])
def test_operator_matches_pallas_backend(shape):
    uj, opj = _pallas_backend_op(dj, shape)
    with dj.switchconfig(backend='pallas'):
        opj.apply(time_M=5, dt=0.05)
    assert getattr(opj.schedule.body[0], '_pallas_plan', None) is not None
    ut, opt_ = _pallas_backend_op(dt, shape)
    assert all(p is not None for _, p in opt_.kernel_plans)
    opt_.apply(time_M=5, dt=0.05)
    assert np.abs(np.array(ut.data) - np.array(uj.data)).max() < 1e-5


def test_increment_runs_in_translator():
    grid = dt.Grid(shape=(16, 16), extent=(15., 15.))
    u = dt.TimeFunction(name='u', grid=grid)
    f = dt.Function(name='f', grid=grid)
    u.data[:] = 1.0
    op = dt.Operator([dt.Eq(u.forward, u), dt.Inc(f, u)])
    assert [p is None for _, p in op.kernel_plans] == [False, True]
    op.apply(time_M=3, dt=1.0)
    assert np.allclose(f.data, 4.0)


def test_generated_source():
    """What the CUDA printer emits: fp32 literals with the f suffix,
    small powers as products, symbols as kernel parameters, loads at
    fixed offsets from the access groups' row pointers (the point design;
    a 3-D star streams by default, tests/test_torch_stencil_stream.py)."""
    g, e = _acoustic_eq(dt, (8, 9, 10), 4, np.float32)
    (it,) = _dense_items(lower_t([e], subs=g.spacing_map))
    plan = K.plan_for(it, _design='point')
    src = plan.source
    assert 'using T = float;' in src and 'constexpr int NG = 4;' in src
    assert plan.param_names == ['dt']
    assert 'a.p[0]' in src and 'pow(' not in src
    assert 'DTPU_LD(g0, ' in src and '-2LL * a.stride[' in src
    import re
    lits = re.findall(r'(?<![\w.\[])(\d+\.\d*(?:e-?\d+)?f?)', src)
    assert lits and all(x.endswith('f') for x in lits)
    g64, e64 = _acoustic_eq(dt, (8, 9, 10), 4, np.float64)
    (it64,) = _dense_items(lower_t([e64], subs=g64.spacing_map))
    src64 = K.plan_for(it64).source
    assert 'using T = double;' in src64
    assert re.search(r'\d\.\d+f', src64) is None


def test_wrapper_checks_rows():
    g, e = _acoustic_eq(dt, (8, 9, 10), 4, np.float32)
    (it,) = _dense_items(lower_t([e], subs=g.spacing_map))
    plan = K.plan_for(it)
    shape = it.target._allocated_space()
    ins = [torch.ones(gr['fn']._allocated_space()) for gr in plan.groups]
    with pytest.raises(TypeError, match='planned for'):
        K.stencil_update(plan, (torch.zeros(shape, dtype=torch.float64),
                                ins), {'dt': 1.0})
    with pytest.raises(ValueError, match='expected'):
        K.stencil_update(plan, (torch.zeros(shape[:-1] + (1,)), ins),
                         {'dt': 1.0})
    with pytest.raises(ValueError, match='access groups'):
        K.stencil_update(plan, (torch.zeros(shape), ins[:-1]), {'dt': 1.0})
    before = K.launches
    K.stencil_update(plan, (torch.zeros(shape), ins), {'dt': 1.0})
    assert K.launches == before   # CPU tensors: the plain version ran


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('shape,so', [((61, 77, 93), 8), ((64, 48), 4)])
def test_kernel_matches_reference_on_card(shape, so, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    with dt.switchconfig(device='cuda'):
        g, e = _acoustic_eq(dt, shape, so, dtype)
    (it,) = _dense_items(lower_t([e], subs=g.spacing_map))
    plan = K.plan_for(it)
    tdt = torch.from_numpy(np.empty(0, dtype)).dtype
    gen = torch.Generator(device='cuda').manual_seed(0)
    ins = [1.5 + torch.rand(gr['fn']._allocated_space(), generator=gen,
                            device='cuda', dtype=tdt) for gr in plan.groups]
    out = torch.zeros(it.target._allocated_space(), device='cuda', dtype=tdt)
    ref = out.clone()
    before = K.launches
    K.stencil_update(plan, (out, ins), {'dt': 0.3})
    K.stencil_update_reference(plan, (ref, ins), {'dt': 0.3})
    torch.cuda.synchronize()
    assert K.launches == before + 1
    tol = (1e-5 if dtype == np.float32 else 1e-12) * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol


def _tti_items(shape, so, dtype=np.float32, trig='auto'):
    """The port's TTI centered forward at ``shape``: (operator, its CIRE
    temporaries' items, its hoisted prologue items)."""
    from devito_tpu_torch.models.seismic import tti as tt
    s = tt.tti_setup(shape=shape, spacing=[15.] * len(shape), tn=30.,
                     space_order=so, nbl=4, dtype=dtype,
                     opt=('advanced', {'hoist-trig-taps': trig}))
    op = s.op_fwd(None)
    temps = [it for it in op.schedule.body if hasattr(it, 'region')
             and it.target.name.startswith('cire')]
    return op, temps, [it for it in op.schedule.prologue if it.internal]


@pytest.mark.parametrize('shape,so', [((14, 15), 8), ((10, 11, 12), 4)])
def test_plan_for_takes_halo_extended_regions(shape, so):
    """CIRE's temporaries are computed into the halo: the point design
    takes them, with the write moved back by the overhang; the streaming
    design declines them by shape, with its reason."""
    _, temps, _ = _tti_items(shape, so)
    ext = [it for it in temps if it.region[0][0] < 0]
    assert ext
    for it in ext:
        plan = K.plan_for(it)
        assert plan is not None and plan.design == 'point'
        hw = -it.region[0][0]
        assert plan.origins[0] == tuple(h - hw for h, _ in it.target.halo)
        if len(shape) == 3:
            assert 'halo-extended region' in plan.design_reason


def test_plan_for_declines_taps_outside_the_allocation():
    """The same temporary over a region wider than its operands' halo:
    a tap would leave u's allocation, so the kernel declines it, and the
    translator raises rather than read past the allocation."""
    from devito_tpu_torch.compiler.executor import _exec_dense
    from devito_tpu_torch.ir.lowering import LoweredEq
    from devito_tpu_torch.exceptions import CompilationError
    op, temps, _ = _tti_items((14, 15), 4)
    it = temps[0]
    so = it.target.space_order
    wide = dt.Function(name='wide', grid=it.target.grid, space_order=3 * so)
    eq = LoweredEq(wide, None, None, tuple((a - so, b + so)
                                           for a, b in it.region), it.rhs)
    assert K.plan_for(eq) is None
    assert 'reads outside its allocation' in K.decline_reason(eq)
    bufs, params = op.arguments(time_M=1, dt=0.1)
    bufs['wide'] = wide._device_array()
    with pytest.raises(CompilationError, match='outside its allocation'):
        _exec_dense(eq, None, bufs, params, 1)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('shape,so', [((14, 15), 8), ((10, 11, 12), 4)])
def test_plain_version_over_halo_extended_region_equals_translator(
        shape, so, dtype):
    """On seeded rows, the kernel's plain version of each CIRE temporary
    and hoisted prologue item writes what the torch translator writes, over
    the whole halo-extended region, and nothing outside it."""
    from devito_tpu_torch.compiler.executor import _exec_dense, plan_rows
    op, temps, hoisted = _tti_items(shape, so, dtype, trig=True)
    assert hoisted and all(it.region[0][0] < 0 for it in hoisted)
    bufs, params = op.arguments(time_M=1, dt=0.1)
    gen = torch.Generator().manual_seed(3)
    for name, b in bufs.items():
        if b.is_floating_point() and not name.endswith('_coords'):
            b.copy_(torch.rand(b.shape, generator=gen, dtype=b.dtype))
    for it in hoisted + temps:
        plan = K.plan_for(it)
        assert plan is not None
        t = None if it in hoisted else 1
        out, ins = plan_rows(plan, bufs, t, params)
        out.zero_()
        K.stencil_update(plan, (out, ins), params)    # CPU: plain version
        got = out.clone()
        out.zero_()
        _exec_dense(it, None, bufs, params, t)        # the translator
        assert got.abs().max() > 0
        tol = (1e-6 if dtype == np.float32 else 1e-13) * got.abs().max()
        assert (got - out).abs().max() <= tol
        region = tuple(slice(o, o + n) for o, n in
                       zip(plan.origins[0], plan.extents))
        outside = got.clone()
        outside[region] = 0
        assert not outside.any()


def test_trig_prologue_source_keeps_fp32():
    """A hoisted trig item and a TTI update print fp32 math calls in an
    fp32 kernel (sinf, cosf, sqrtf; no double-precision call), fp64 ones
    in an fp64 kernel."""
    import re
    for dtype, names in ((np.float32, ('cosf(', 'sinf(')),
                         (np.float64, ('cos(', 'sin('))):
        op, temps, hoisted = _tti_items((10, 11, 12), 4, dtype, trig=True)
        srcs = [K.plan_for(it).source for it in hoisted]
        assert any(n in s for s in srcs for n in names)
        body = [K.plan_for(it).source for it in op.schedule.body
                if hasattr(it, 'region')]
        if dtype == np.float32:
            calls = set(re.findall(r'\b([a-z]+[0-9]*)\(', ' '.join(
                s.split('eval(', 1)[1] for s in srcs + body)))
            assert not calls & {'sin', 'cos', 'sqrt', 'rsqrt', 'pow', 'exp'}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('shape,so', [((64, 48), 8), ((30, 33, 40), 12)])
def test_halo_extended_kernel_matches_reference_on_card(shape, so, dtype):
    """K1's point design over CIRE's halo-extended temporaries and the
    hoisted trig items against its plain version, on seeded rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    from devito_tpu_torch.compiler.executor import plan_rows
    with dt.switchconfig(device='cuda'):
        op, temps, hoisted = _tti_items(shape, so, dtype, trig=True)
        bufs, params = op.arguments(time_M=1, dt=0.1)
    gen = torch.Generator(device='cuda').manual_seed(3)
    for name, b in bufs.items():
        if b.is_floating_point() and not name.endswith('_coords'):
            b.copy_(torch.rand(b.shape, generator=gen, device='cuda',
                               dtype=b.dtype))
    for it in hoisted + temps:
        plan = K.plan_for(it)
        out, ins = plan_rows(plan, bufs, None if it in hoisted else 1, params)
        out.zero_()
        ref = out.clone()
        before = K.launches
        K.stencil_update(plan, (out, ins), params)
        K.stencil_update_reference(plan, (ref, ins), params)
        torch.cuda.synchronize()
        assert K.launches == before + 1
        tol = (1e-5 if dtype == np.float32 else 1e-12) * ref.abs().max()
        assert (out - ref).abs().max() <= tol


# -- fused units (kernels/stencil.py plan_run) on the card ------------------

def _fused_units(solver, dtype):
    """The fused units of the elastic SO=4 or the TTI SO=12 forward
    (hoist-trig-taps True, as 'auto' picks at the benchmark's size) at
    about 64^3, built on the card, and their operator."""
    from devito_tpu_torch.models.seismic import elastic_setup, tti_setup
    with dt.switchconfig(device='cuda'):
        if solver == 'elastic':
            s = elastic_setup(shape=(64, 60, 56), spacing=(10.,) * 3, tn=20.,
                              nbl=6, space_order=4, dtype=dtype)
        else:
            s = tti_setup(shape=(60, 56, 64), spacing=(15.,) * 3, tn=20.,
                          space_order=12, nbl=4, dtype=dtype,
                          opt=('advanced', {'hoist-trig-taps': True}))
        op = s.op_fwd(None)
    units = list({id(p): p for _, p in op.kernel_plans
                  if p is not None and p.nt > 1}.values())
    return s, op, units


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('solver', ['elastic', 'tti'])
def test_fused_units_equal_their_members_on_card(solver, dtype):
    """Each fused unit writes, bit for bit, what its equations' own units
    write one launch each, on the same seeded rows, in one launch; its
    build spills nothing (ptxas's report, when it ran in this process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    _, _, units = _fused_units(solver, dtype)
    assert len(units) == 2
    tdt = torch.from_numpy(np.empty(0, dtype)).dtype
    gen = torch.Generator(device='cuda').manual_seed(5)
    for unit in units:
        ins = [1 + torch.rand(g['fn']._allocated_space(), generator=gen,
                              device='cuda', dtype=tdt) for g in unit.groups]
        outs = [torch.rand(e.target._allocated_space(), generator=gen,
                           device='cuda', dtype=tdt) for e in unit.eqs]
        rows = {g['key']: r for g, r in zip(unit.groups, ins)}
        alone = [K.plan_for(e) for e in unit.eqs]
        got = [o.clone() for o in outs]
        want = [o.clone() for o in outs]
        before = K.launches
        K.stencil_update(unit, (got, ins), {n: 0.7 for n in
                                            unit.param_names})
        assert K.launches == before + 1
        for p, w in zip(alone, want):
            K.stencil_update(p, (w, [rows[g['key']] for g in p.groups]),
                             {n: 0.7 for n in p.param_names})
        torch.cuda.synchronize()
        for e, g, w, o in zip(unit.eqs, got, want, outs):
            assert torch.equal(g, w), e.target.name
            assert not torch.equal(g, o)
        log = K.build_log.get(unit.key)
        if log is not None:
            assert ' 0 bytes spill stores' in log and \
                ' 0 bytes spill loads' in log, log


@pytest.mark.cuda
@pytest.mark.parametrize('solver', ['elastic', 'tti'])
def test_fused_units_launch_once_a_step_on_card(solver):
    """The forward launches each fused unit once a step, in place of its
    equations' launches: K1's launches are the distinct units' counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    s, op, units = _fused_units(solver, np.float32)
    plans = list({id(p): p for _, p in op.kernel_plans}.values())
    before = K.launches
    with dt.switchconfig(device='cuda'):
        s.forward()
    steps = units[0].launches
    assert steps >= 10 and all(u.launches == steps for u in units)
    assert K.launches - before == sum(p.launches for p in plans)


@pytest.mark.cuda
@pytest.mark.parametrize('chunk', [10, 30])
def test_chunked_launch_equals_the_whole_on_card(chunk):
    """A point unit run in chunks of rows (``chunk_rows``; the last chunk
    short) writes what its launch of one chunk writes, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    _, _, units = _fused_units('elastic', np.float32)
    gen = torch.Generator(device='cuda').manual_seed(6)
    for unit in units:
        assert unit.chunk_rows == 0 and unit.extents[1] % chunk
        ins = [1 + torch.rand(g['fn']._allocated_space(), generator=gen,
                              device='cuda') for g in unit.groups]
        outs = [torch.rand(e.target._allocated_space(), generator=gen,
                           device='cuda') for e in unit.eqs]
        whole = [o.clone() for o in outs]
        params = {n: 0.7 for n in unit.param_names}
        K.stencil_update(unit, (whole, ins), params)
        unit.chunk_rows = chunk
        try:
            K.stencil_update(unit, (outs, ins), params)
        finally:
            unit.chunk_rows = 0
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, whole))
