"""The acoustic inverse problem through devito_tpu_torch: the adjoint, the
FWI gradient and Born.

- Against devito_tpu, fp64, from identical state carried over with
  ``load_numpy_state`` (each package builds its own problem): the
  adjoint's ``srca`` (2-D and 3-D), the full-save gradient and Born's
  record, each within 1e-10 x max, as tests/test_torch_acoustic.py holds
  the forward; and the operators' default time bounds.
- Inside the port, at BASELINE.md's tolerances as devito_tpu's own tests
  hold them: the F dot test at atol 1e-11 (tests/test_adjoint.py:45),
  the J dot test at 1e-12 (:142), the inject/interpolate pair at 1e-6
  (:73), and the Taylor slopes 1.0 and 2.0 within rtol 0.1
  (tests/test_gradient.py:68-69).
- Which design of K1 each update takes (decided from the equation's
  shape, so checked here); on the card (``cuda``), the backward streaming
  update against its plain version and the point design, and the
  operators' launches by design.
"""

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu.builtins import smooth as smooth_j  # noqa: E402
from devito_tpu.models import seismic as sj  # noqa: E402
from devito_tpu_torch.builtins import inner, norm, smooth  # noqa: E402
from devito_tpu_torch.kernels import stencil as K  # noqa: E402
from devito_tpu_torch.models import seismic as st  # noqa: E402
from devito_tpu_torch.utils import load_numpy_state, numpy_state  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

#: Port against devito_tpu over a whole run, fp64 (tests/test_torch_acoustic.py)
RUN_TOL = 1e-10


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _setup(seis, shape, so, nbl, tn, spacing=15., **kwargs):
    return seis.acoustic_setup(shape=shape, spacing=(spacing,) * len(shape),
                               nbl=nbl, tn=tn, space_order=so,
                               preset='layers-isotropic', dtype=np.float64,
                               **kwargs)


def _close(got, want, tol=RUN_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(want).max() > 0
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- against devito_tpu -------------------------------------------------------

@pytest.mark.parametrize('shape,so,nbl,tn', [((40, 45), 4, 10, 250.),
                                             ((20, 22, 24), 8, 6, 120.)])
def test_adjoint_matches_devito_tpu(shape, so, nbl, tn):
    J = _setup(sj, shape, so, nbl, tn)
    rec = J.forward(save=False)[0]
    srca = J.geometry.new_src(name='srca', src_type=None)
    v = dj.TimeFunction(name='v', grid=J.model.grid, time_order=2,
                        space_order=so)
    state = numpy_state([J.model.vp, J.model.damp, rec, srca, v])
    J.adjoint(rec, srca=srca, v=v)

    T = _setup(st, shape, so, nbl, tn)
    assert T.dt == J.dt and T.geometry.nt == J.geometry.nt
    recT = T.geometry.rec
    srcaT = T.geometry.new_src(name='srca', src_type=None)
    vT = dt.TimeFunction(name='v', grid=T.model.grid, time_order=2,
                         space_order=so)
    load_numpy_state([T.model.vp, T.model.damp, recT, srcaT, vT], state)
    T.adjoint(recT, srca=srcaT, v=vT)
    _close(srcaT.data, srca.data)
    _close(vT.data, v.data)


def test_default_time_bounds_match_devito_tpu():
    """Every new operator runs t over the same default range in both
    packages: [1, nt-2] for the backward ones too."""
    J = _setup(sj, (30, 32), 4, 6, 100.)
    T = _setup(st, (30, 32), 4, 6, 100.)
    nt = T.geometry.nt
    for make in (lambda s: s.op_adj(), lambda s: s.op_grad(),
                 lambda s: s.op_grad(save=False), lambda s: s.op_born()):
        opj, opt = make(J), make(T)
        assert opt._default_time_bounds() == opj._default_time_bounds()
        assert opt._default_time_bounds() == (1, nt - 2)
        assert opt.schedule.direction == opj._schedule.direction
    assert T.op_adj().schedule.direction == -1
    assert T.op_grad().schedule.direction == -1
    assert T.op_born().schedule.direction == 1


def _fwi_state(shape=(40, 45), so=4, nbl=20, tn=250.):
    """devito_tpu's FWI problem (tests/test_checkpointing.py's): the
    smoothed model vel0, the residual and the full-save forward wavefield
    at vel0; returns the solver, the state of every function and the
    full-save gradient."""
    J = _setup(sj, shape, so, nbl, tn, spacing=10.)
    vel0 = dj.Function(name='vel0', grid=J.model.grid, space_order=so)
    smooth_j(vel0, J.model.vp)
    rec = J.forward()[0]
    rec0, u0 = J.forward(vp=vel0, save=True)[0:2]
    res = sj.Receiver(name='resid', grid=J.model.grid,
                      data=np.asarray(rec0.data) - np.asarray(rec.data),
                      time_range=J.geometry.time_axis,
                      coordinates=J.geometry.rec_positions)
    state = numpy_state([J.model.vp, J.model.damp, vel0, res, u0])
    g, _ = J.jacobian_adjoint(res, u0, vp=vel0)
    return J, state, np.array(g.data)


def _port_fwi(state, shape=(40, 45), so=4, nbl=20, tn=250.):
    """The port's problem with devito_tpu's state loaded: (solver, vel0,
    residual, the full-save wavefield as a save=nt TimeFunction)."""
    T = _setup(st, shape, so, nbl, tn, spacing=10.)
    vel0 = dt.Function(name='vel0', grid=T.model.grid, space_order=so)
    u0 = dt.TimeFunction(name='u', grid=T.model.grid, save=T.geometry.nt,
                         time_order=2, space_order=so)
    load_numpy_state([T.model.vp, T.model.damp, vel0, u0], state)
    res = st.Receiver(name='resid', grid=T.model.grid, data=state['resid'],
                      time_range=T.geometry.time_axis,
                      coordinates=state['resid_coords'])
    assert np.array_equal(res.data, state['resid'])
    return T, vel0, res, u0


def test_gradient_matches_devito_tpu():
    _, state, gj = _fwi_state()
    T, vel0, res, u0 = _port_fwi(state)
    g, _ = T.jacobian_adjoint(res, u0, vp=vel0)
    _close(g.data, gj)


@pytest.mark.parametrize('shape,so,nbl,tn', [((40, 45), 4, 10, 250.),
                                             ((20, 22, 24), 8, 6, 120.)])
def test_born_matches_devito_tpu(shape, so, nbl, tn):
    J = _setup(sj, shape, so, nbl, tn)
    dm = dj.Function(name='dm', grid=J.model.grid, space_order=0)
    dm.data[:] = 1e-2 * np.random.default_rng(0).standard_normal(dm.shape)
    state = numpy_state([J.model.vp, J.model.damp, dm])
    rj = np.array(J.jacobian(dm)[0].data)

    T = _setup(st, shape, so, nbl, tn)
    dmT = dt.Function(name='dm', grid=T.model.grid, space_order=0)
    load_numpy_state([T.model.vp, T.model.damp, dmT], state)
    rec, u, U, _ = T.jacobian(dmT)
    _close(rec.data, rj)
    assert U.name == 'U' and u.name == 'u'


def test_state_carries_every_function_the_new_operators_read():
    """numpy_state of devito_tpu's operands loads into the port's, by
    name, for every function the adjoint, gradient and Born operators
    read: v, U, grad, dm (space_order=0), srca, the receivers, vp, damp."""
    J = _setup(sj, (24, 26), 4, 4, 60.)
    T = _setup(st, (24, 26), 4, 4, 60.)
    rng = np.random.default_rng(3)
    for make in (lambda s: s.op_adj(), lambda s: s.op_grad(),
                 lambda s: s.op_born()):
        fj = {f.name: f for f in make(J).reads}
        ft = {f.name: f for f in make(T).reads}
        assert set(fj) == set(ft)
        for f in fj.values():
            view = f.data if f.is_SparseFunction else f.data_with_halo
            view[:] = rng.standard_normal(np.shape(view))
        state = numpy_state(fj)
        load_numpy_state(ft, state)
        for name, f in ft.items():
            got = f.data if f.is_SparseFunction else f.data_with_halo
            assert np.array_equal(got, state[name]), name
    assert {'v', 'U', 'grad', 'dm', 'srca', 'rec', 'vp', 'damp'} <= \
        {f.name for mk in ('op_adj', 'op_grad', 'op_born')
         for f in getattr(T, mk)().reads}


def test_builtins_on_the_new_functions_match_devito_tpu():
    J = _setup(sj, (30, 32), 4, 6, 100.)
    T = _setup(st, (30, 32), 4, 6, 100.)
    load_numpy_state([T.model.vp], numpy_state([J.model.vp]))
    vj = dj.Function(name='vel0', grid=J.model.grid, space_order=4)
    vt = dt.Function(name='vel0', grid=T.model.grid, space_order=4)
    smooth_j(vj, J.model.vp)
    smooth(vt, T.model.vp)
    assert np.array_equal(vt.data, np.asarray(vj.data))
    srca = T.geometry.new_src(name='srca', src_type=None)
    assert isinstance(srca, st.PointSource) and not isinstance(
        srca, st.WaveletSource) and not np.any(srca.data)
    srca.data[:] = 2.
    src = T.geometry.src
    assert np.isclose(inner(srca, src), 2 * np.asarray(src.data).sum(),
                      rtol=1e-14)
    assert np.isclose(norm(srca), 2 * np.sqrt(srca.data.size), rtol=1e-14)


# -- inside the port -----------------------------------------------------------

@pytest.mark.parametrize('shape,so', [((60, 70), 8), ((30, 35, 30), 4)])
def test_adjoint_F(shape, so):
    """<F x, y> == <x, F^T y> (tests/test_adjoint.py:32, atol 1e-11)."""
    solver = _setup(st, shape, so, 10, 250.)
    srca = solver.geometry.new_src(name='srca', src_type=None)
    rec = solver.forward(save=False)[0]
    solver.adjoint(rec=rec, srca=srca)
    term1 = inner(srca, solver.geometry.src)
    term2 = norm(rec) ** 2
    assert np.isclose((term1 - term2) / term1, 0., atol=1.e-11), \
        (term1, term2, (term1 - term2) / term1)


def test_adjoint_J():
    """<J dm, y> == <dm, J' y> (tests/test_adjoint.py:121, atol 1e-12)."""
    shape, so = (40, 45), 4
    solver = st.acoustic_setup(shape=shape, spacing=[10.] * 2, nbl=12,
                               tn=250., space_order=so,
                               preset='layers-isotropic', dtype=np.float64,
                               vp_bottom=2)
    model0 = st.demo_model('layers-isotropic', vp_top=1.5, vp_bottom=1.5,
                           spacing=(10., 10.), space_order=so, shape=shape,
                           nbl=12, dtype=np.float64, grid=solver.model.grid)
    dm = (np.asarray(solver.model.vp.data) ** -2
          - np.asarray(model0.vp.data) ** -2)
    dmf = dt.Function(name='dmf', grid=solver.model.grid, space_order=0)
    dmf.data[:] = dm
    du = solver.jacobian(dmf, model=model0)[0]
    u0 = solver.forward(save=True, model=model0)[1]
    im, _ = solver.jacobian_adjoint(du, u0, model=model0)
    term1 = float(np.dot(np.asarray(im.data).ravel(), dm.ravel()))
    term2 = norm(du) ** 2
    assert np.isclose((term1 - term2) / term1, 0., atol=1e-12), \
        (term1, term2)


@pytest.mark.parametrize('shape,coords', [
    ((11, 11), [(.05, .9), (.01, .8)]),
    ((11, 11, 11), [(.05, .9), (.01, .8), (0.07, 0.84)]),
])
def test_adjoint_inject_interpolate(shape, coords, npoints=19):
    """p.inject is the adjoint of p.interpolate (tests/test_adjoint.py:52,
    atol 1e-6)."""
    grid = dt.Grid(shape, dtype=np.float64)
    a = dt.Function(name='a', grid=grid, space_order=1)
    c = dt.Function(name='c', grid=grid, space_order=1)
    c.data[:] = 27.
    pcoords = np.zeros((npoints, len(shape)))
    for i, r in enumerate(coords):
        pcoords[:, i] = np.linspace(r[0], r[1], npoints)
    p = dt.SparseFunction(name='p', grid=grid, npoint=npoints,
                          coordinates=pcoords)
    p.data[:] = 1.2
    p2 = dt.SparseFunction(name='p2', grid=grid, npoint=npoints,
                           coordinates=pcoords.copy())
    dt.Operator([p.inject(field=a, expr=p), p2.interpolate(expr=c)])()
    term1 = inner(p2, p)
    term2 = inner(c, a)
    assert np.isclose((term1 - term2) / term1, 0., atol=1.e-6), \
        (term1, term2)


def test_gradient_taylor_slopes():
    """First- and second-order Taylor error slopes of the FWI objective,
    1.0 and 2.0 within rtol 0.1 (tests/test_gradient.py:23, same size)."""
    so = 4
    wave = st.acoustic_setup(shape=(50, 60), spacing=(10., 10.),
                             dtype=np.float64, kernel='OT2', tn=400.0,
                             space_order=so, nbl=40,
                             preset='layers-isotropic')
    vel0 = dt.Function(name='vel0', grid=wave.model.grid, space_order=so)
    smooth(vel0, wave.model.vp)
    v = np.array(wave.model.vp.data)
    vel0d = np.array(vel0.data)
    dm = v ** (-2) - vel0d ** (-2)
    rec = np.array(wave.forward()[0].data)
    rec0, u0 = wave.forward(vp=vel0, save=True)[0:2]
    rec0 = np.array(rec0.data)
    F0 = .5 * np.linalg.norm(rec0 - rec) ** 2
    residual = st.Receiver(name='rec_res', grid=wave.model.grid,
                           data=rec0 - rec,
                           time_range=wave.geometry.time_axis,
                           coordinates=wave.geometry.rec_positions)
    gradient, _ = wave.jacobian_adjoint(residual, u0, vp=vel0)
    G = np.dot(np.asarray(gradient.data).reshape(-1), dm.reshape(-1))

    H = [0.5, 0.25, .125, 0.0625, 0.0312, 0.015625, 0.0078125]
    error1, error2 = np.zeros(7), np.zeros(7)
    for i, h in enumerate(H):
        vloc = dt.Function(name=f'vloc{i}', grid=wave.model.grid,
                           space_order=so)
        vloc.data[:] = np.sqrt(vel0d ** 2 * v ** 2 /
                               ((1 - h) * v ** 2 + h * vel0d ** 2))
        d = np.array(wave.forward(vp=vloc)[0].data)
        F_i = .5 * np.linalg.norm((d - rec).reshape(-1)) ** 2
        error1[i] = np.absolute(F_i - F0)
        error2[i] = np.absolute(F_i - F0 - h * G)
    p1 = np.polyfit(np.log10(H), np.log10(error1), 1)
    p2 = np.polyfit(np.log10(H), np.log10(error2), 1)
    assert np.isclose(p1[0], 1.0, rtol=0.1), p1
    assert np.isclose(p2[0], 2.0, rtol=0.1), p2


# -- which design each update takes ------------------------------------------

def _solver_3d(dtype=np.float64, shape=(20, 22, 24)):
    return st.acoustic_setup(shape=shape, spacing=(15.,) * 3, nbl=6,
                             tn=60., space_order=8,
                             preset='layers-isotropic', dtype=dtype)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_inverse_update_designs(dtype):
    """The adjoint's and the gradient's v.backward and Born's u.forward
    stream; Born's U.forward reads seven centre groups, whose tiles do not
    fit two streaming CTAs on an SM at the first tile, so it streams on a
    later one; the gradient's increment is declined and runs in the torch
    translator."""
    solver = _solver_3d(dtype)
    (adj_eq, adj), = solver.op_adj().kernel_plans
    assert adj.design == 'stream' and adj_eq.time_off == -1
    assert adj.design_reason.startswith('3-D star of v, radii (4, 4, 4)')

    (v_eq, v_plan), (inc, inc_plan) = solver.op_grad().kernel_plans
    assert v_plan.design == 'stream' and v_plan.source == adj.source
    assert inc_plan is None and inc.increment
    assert K.decline_reason(inc) == 'increment'
    assert K.decline_reason(adj_eq) is None

    (u_eq, u_plan), (U_eq, U_plan) = solver.op_born().kernel_plans
    assert (u_eq.target.name, U_eq.target.name) == ('u', 'U')
    assert u_plan.design == 'stream'
    assert U_plan.design == 'stream'
    assert len(U_plan.centre) == 7 and len(U_plan.staged) == 1
    first = K.STREAM_TILES[np.dtype(dtype).itemsize][0]
    assert K.stream_tile(dtype, (4, 4, 4), 1, 7, first) is None
    t = U_plan.tile
    assert (t['ty'], t['tz'], t['py'], t['stages'], t['tx']) != first
    assert U_plan.design_reason.startswith(
        "3-D star of U, radii (4, 4, 4), tile ")


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_backward_stream_update_on_card(dtype):
    """One backward update (the adjoint's v[t-1] from v[t], v[t+1], vp,
    damp) through the streaming kernel, the point design and the plain
    version on the same seeded rows; the kernel spills nothing and two or
    more of its CTAs share an SM."""
    _card()
    with dt.switchconfig(device='cuda'):
        solver = _solver_3d(dtype, shape=(61, 77, 93))
        (_, plan), = solver.op_adj().kernel_plans
    assert plan.design == 'stream'
    tdt = torch.from_numpy(np.empty(0, dtype)).dtype
    gen = torch.Generator(device='cuda').manual_seed(0)
    ins = []
    for g in plan.groups:
        r = torch.randn(g['fn']._allocated_space(), generator=gen,
                        device='cuda', dtype=tdt)
        ins.append(1.5 + r.abs() if g['fn'].name == 'vp' else
                   0.01 * r.abs() if g['fn'].name == 'damp' else r)
    out = torch.randn(plan.eq.target._allocated_space(), generator=gen,
                      device='cuda', dtype=tdt)
    got, pnt, ref = out.clone(), out.clone(), out.clone()
    params = {n: 0.7 for n in plan.param_names}
    K.stencil_update(plan, (got, ins), params)
    K.stencil_update(K.plan_for(plan.eq, _design='point'), (pnt, ins), params)
    K.stencil_update_reference(plan, (ref, ins), params)
    torch.cuda.synchronize()
    tol = {np.float32: 1e-5, np.float64: 1e-12}[dtype] * ref.abs().max()
    assert (got - ref).abs().max() <= tol
    assert (got - pnt).abs().max() <= tol
    log = K.build_log.get(plan.key)
    if log is not None:
        assert ' 0 bytes spill stores' in log and \
            ' 0 bytes spill loads' in log, log
    assert K.stream_occupancy(plan) >= 2


@pytest.mark.cuda
def test_smooth_streams_on_card():
    """builtins.smooth's moving average along z streams with radii (0, 0,
    1) -- no x taps, no y halo -- and matches the plain version."""
    _card()
    out = {}
    for device in ('cpu', 'cuda'):
        with dt.switchconfig(device=device):
            solver = _solver_3d(np.float32, shape=(61, 77, 93))
            vp0 = dt.Function(name='vp0', grid=solver.model.grid,
                              space_order=8)
            before = dict(K.launches_by_design)
            smooth(vp0, solver.model.vp)
            out[device] = np.array(vp0.data)
    assert K.launches_by_design == {'stream': before['stream'] + 1,
                                    'point': before['point']}
    _close(out['cuda'], out['cpu'], tol=1e-6)


@pytest.mark.cuda
def test_inverse_operators_on_card():
    """The adjoint, Born and both gradients on the card, fp64: launches by
    design as the plans imply, the adjoint against the plain version from
    the same state, and the checkpointed gradient bit-equal to the
    full-save one."""
    _card()
    shape, so, nbl, tn = (40, 44, 48), 8, 6, 100.
    with dt.switchconfig(device='cpu'):
        P = _setup(st, shape, so, nbl, tn)
        rec = P.forward(save=False)[0]
        state = numpy_state([P.model.vp, P.model.damp, rec])
        want = np.array(P.adjoint(rec)[0].data)
    with dt.switchconfig(device='cuda'):
        C = _setup(st, shape, so, nbl, tn)
        recC = C.geometry.rec
        load_numpy_state([C.model.vp, C.model.damp, recC], state)
        nsteps = C.geometry.nt - 2
        before = dict(K.launches_by_design)
        srca = C.adjoint(recC)[0]
        assert K.launches_by_design == {'stream': before['stream'] + nsteps,
                                        'point': before['point']}
        _close(srca.data, want)

        dm = dt.Function(name='dm', grid=C.model.grid, space_order=0)
        dm.data[:] = 1e-2
        before = dict(K.launches_by_design)
        du = C.jacobian(dm)[0]
        assert K.launches_by_design == {'stream': before['stream'] + nsteps,
                                        'point': before['point'] + nsteps}
        u0 = C.forward(save=True)[1]
        full = np.array(C.jacobian_adjoint(du, u0)[0].data)
        ck = np.array(C.jacobian_adjoint(du, None, checkpointing=True)[0]
                      .data)
    assert np.abs(full).max() > 0 and np.array_equal(ck, full)
