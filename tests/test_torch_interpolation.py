"""Sinc, precomputed and matrix interpolation through devito_tpu_torch
against devito_tpu: each package builds its own grid, fields and sparse
function from the same seeded numpy state, interpolates and injects, and
the sparse rows and the injected fields agree to fp64 rtol 1e-12 (max
|diff| over max |devito_tpu|). Points outside the grid contribute zero,
and corners clipped onto the edge accumulate."""

import numpy as np
import pytest
import torch

import devito_tpu as dj
import devito_tpu_torch as dt
from devito_tpu.models import seismic as sj_
from devito_tpu_torch.models import seismic as st_
from devito_tpu_torch.utils import load_numpy_state, numpy_state

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

RTOL = 1e-12
SHAPES = {2: (13, 15), 3: (9, 10, 11)}


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def coords(shape, rng, npoint):
    """Seeded points in grid units (spacing 1): inside, on the last node,
    half a cell from the edges (corners clipped onto the edge) and one
    outside the grid."""
    n = np.array(shape, dtype=np.float64) - 1
    pts = rng.uniform(0, 1, (npoint, len(shape))) * n
    pts[0] = n                      # the last node
    pts[1] = 0.5                    # corners clipped at the low edge
    pts[2] = n - 0.5                # ... and at the high edge
    pts[3, 0] = n[0] + 0.7          # outside the grid
    return pts


def sinc_case(pkg, ndim, r, state):
    """(interpolated rows, injected field) of a sinc sparse function in
    package ``pkg`` on ``state``."""
    grid = pkg.Grid(shape=SHAPES[ndim], extent=tuple(
        n - 1. for n in SHAPES[ndim]), dtype=np.float64)
    f = pkg.Function(name='f', grid=grid, space_order=r)
    g = pkg.Function(name='g', grid=grid, space_order=r)
    p = pkg.SparseFunction(name='p', grid=grid, npoint=len(state['coords']),
                           interpolation='sinc', r=r)
    q = pkg.SparseFunction(name='q', grid=grid, npoint=len(state['coords']),
                           interpolation='sinc', r=r)
    f.data[:] = state['f']
    for s in (p, q):
        s.coordinates.data[:] = state['coords']
    q.data[:] = state['q']
    pkg.Operator([p.interpolate(expr=f), q.inject(field=g, expr=q)]).apply()
    return np.array(p.data), np.array(g.data)


def sinc_numpy(ndim, r, state):
    """(interpolated rows, injected field) from devito_tpu's sinc weights
    (``SincInterpolator.dim_weights``) and numpy: the corners base-r+1 ..
    base+r of each axis, clipped onto the grid and accumulated; a point
    outside the grid weighs zero."""
    from itertools import product
    shape = SHAPES[ndim]
    pts = state['coords']
    interp = dj.types.sparse.SparseFunction(
        name='w', npoint=1, grid=dj.Grid(shape=shape),
        interpolation='sinc', r=r).interpolator
    axes = [interp.dim_weights(pts[:, j]) for j in range(ndim)]
    inside = np.all((pts >= 0) & (pts <= np.array(shape) - 1), 1)
    rows, field = np.zeros(len(pts)), np.zeros(shape)
    for combo in product(*[range(2 * r)] * ndim):
        w = inside.astype(np.float64)
        idx = []
        for (offs, ws, base), c, n in zip(axes, combo, shape):
            w = w * np.asarray(ws[c])
            idx.append(np.clip(np.asarray(base) + offs[c], 0, n - 1))
        rows += w * state['f'][tuple(idx)]
        np.add.at(field, tuple(idx), w * state['q'])
    return rows, field


@pytest.mark.parametrize('ndim,r,ref', [
    (2, 2, 'operator'), (2, 4, 'operator'), (3, 2, 'operator'),
    (3, 4, 'weights')])
def test_sinc_matches_devito_tpu(ndim, r, ref):
    """Against devito_tpu's operator; in 3-D at r=4 (512 corners a point,
    which XLA takes over a minute to compile) against devito_tpu's sinc
    weights gathered and scattered in numpy."""
    rng = np.random.default_rng(10 * ndim + r)
    state = dict(f=rng.standard_normal(SHAPES[ndim]),
                 coords=coords(SHAPES[ndim], rng, 12),
                 q=rng.standard_normal(12))
    got = sinc_case(dt, ndim, r, state)
    want = sinc_case(dj, ndim, r, state) if ref == 'operator' else \
        sinc_numpy(ndim, r, state)
    for a, b in zip(got, want):
        assert_close(a, b)
    # the point outside the grid samples zero
    assert got[0][3] == 0


def precomputed_state(ndim, width, rng, npoint=7):
    """Seeded gridpoints (minimum indices: one at the last node, so its
    upper points clip onto the edge; one outside the grid) and
    coefficient tables."""
    shape = SHAPES[ndim]
    gp = np.stack([rng.integers(0, n - width, npoint) for n in shape], 1)
    gp[0] = np.array(shape) - 1
    gp[1, 0] = -1
    return dict(gp=gp, coeffs=rng.uniform(-1, 1, (npoint, ndim, width)),
                u=rng.standard_normal((3,) + shape),
                q=rng.standard_normal((3, npoint)))


def precomputed_case(pkg, ndim, state):
    grid = pkg.Grid(shape=SHAPES[ndim], dtype=np.float64)
    npoint, _, width = state['coeffs'].shape
    u = pkg.TimeFunction(name='u', grid=grid, save=3, space_order=4)
    g = pkg.TimeFunction(name='g', grid=grid, save=3, space_order=4)
    kw = dict(grid=grid, npoint=npoint, nt=3, r=width,
              gridpoints=state['gp'], interpolation_coeffs=state['coeffs'])
    p = pkg.PrecomputedSparseTimeFunction(name='p', **kw)
    q = pkg.PrecomputedSparseTimeFunction(name='q', **kw)
    u.data[:] = state['u']
    q.data[:] = state['q']
    pkg.Operator([p.interpolate(expr=u), q.inject(field=g, expr=q)]).apply(
        time_m=0, time_M=2)
    return np.array(p.data), np.array(g.data)


@pytest.mark.parametrize('ndim', [2, 3])
@pytest.mark.parametrize('width', [2, 3])
def test_precomputed_matches_devito_tpu(ndim, width):
    state = precomputed_state(ndim, width, np.random.default_rng(ndim))
    got, want = (precomputed_case(pkg, ndim, state) for pkg in (dt, dj))
    for a, b in zip(got, want):
        assert_close(a, b)
    assert not got[0][:, 1].any()    # gridpoint outside: zero


def test_precomputed_linear_equals_linear():
    """Precomputed linear coefficients reproduce linear interpolation."""
    rng = np.random.default_rng(5)
    grid = dt.Grid(shape=(11, 12), extent=(10., 11.), dtype=np.float64)
    u = dt.Function(name='u', grid=grid)
    u.data[:] = rng.standard_normal((11, 12))
    pts = rng.uniform(0, 9.9, (6, 2))
    base = np.floor(pts)
    frac = pts - base
    coeffs = np.stack([1 - frac, frac], -1)
    p = dt.PrecomputedSparseFunction(name='p', grid=grid, npoint=6, r=2,
                                     gridpoints=base.astype(int),
                                     interpolation_coeffs=coeffs)
    s = dt.SparseFunction(name='s', grid=grid, npoint=6, coordinates=pts)
    dt.Operator([p.interpolate(expr=u), s.interpolate(expr=u)]).apply()
    assert_close(p.data, s.data, 1e-14)


def msf_case(pkg, ndim, state):
    grid = pkg.Grid(shape=SHAPES[ndim], dtype=np.float64)
    u = pkg.TimeFunction(name='u', grid=grid, save=3, space_order=2)
    g = pkg.TimeFunction(name='g', grid=grid, save=3, space_order=2)
    out = []
    for name in ('m', 'n'):
        msf = pkg.MatrixSparseTimeFunction(name=name, grid=grid, r=2, nt=3,
                                           matrix=state['matrix'])
        msf.gridpoints.data[:] = state['gp']
        for j, d in enumerate(grid.dimensions):
            msf.interpolation_coefficients[d].data[:] = \
                state['coeffs'][:, j, :]
        msf.manual_scatter()
        out.append(msf)
    m, n = out
    u.data[:] = state['u']
    n.data[:] = state['q']
    pkg.Operator([m.interpolate(expr=u), n.inject(field=g, expr=n)]).apply(
        time_m=0, time_M=2)
    m.manual_gather()
    return np.array(m.data), np.array(g.data)


@pytest.mark.parametrize('ndim', [2, 3])
def test_msf_matches_devito_tpu(ndim):
    rng = np.random.default_rng(30 + ndim)
    state = precomputed_state(ndim, 2, rng, npoint=5)
    state['matrix'] = rng.standard_normal((5, 3))
    state['q'] = rng.standard_normal((3, 3))
    got, want = (msf_case(pkg, ndim, state) for pkg in (dt, dj))
    for a, b in zip(got, want):
        assert_close(a, b)


def test_msf_matrix_goes_to_the_device_once_an_apply(monkeypatch):
    """A matrix function's matrix is converted to a tensor once an apply,
    with its geometry, and not at every step of the time loop."""
    from devito_tpu_torch.compiler import executor
    rng = np.random.default_rng(33)
    state = precomputed_state(2, 2, rng, npoint=5)
    state['matrix'] = rng.standard_normal((5, 3))
    state['q'] = rng.standard_normal((3, 3))
    calls, as_tensor = [], torch.as_tensor

    def counted(x, *args, **kwargs):
        if isinstance(x, np.ndarray) and x.shape == (5, 3):
            calls.append(x)
        return as_tensor(x, *args, **kwargs)
    monkeypatch.setattr(executor.torch, 'as_tensor', counted)
    msf_case(dt, 2, state)
    # one apply, two matrix functions (one interpolating, one injecting)
    # over three steps
    assert len(calls) == 2


def test_state_carries_the_tables():
    """numpy_state / load_numpy_state carry a precomputed function's
    gridpoints and coefficients and a matrix function's gridpoints,
    coefficients and matrix from devito_tpu into the port."""
    rng = np.random.default_rng(8)
    state = precomputed_state(2, 2, rng, npoint=5)
    state['matrix'] = rng.standard_normal((5, 3))
    fns = {}
    for pkg, fill in ((dj, True), (dt, False)):
        grid = pkg.Grid(shape=SHAPES[2], dtype=np.float64)
        gp, coeffs = state['gp'], state['coeffs']
        if not fill:
            gp, coeffs = np.zeros_like(gp), np.zeros_like(coeffs)
        p = pkg.PrecomputedSparseTimeFunction(
            name='p', grid=grid, npoint=5, nt=3, r=2, gridpoints=gp,
            interpolation_coeffs=coeffs)
        m = pkg.MatrixSparseTimeFunction(
            name='m', grid=grid, r=2, nt=3,
            matrix=state['matrix'] if fill else np.zeros((5, 3)))
        if fill:
            m.gridpoints.data[:] = gp
            for j, d in enumerate(grid.dimensions):
                m.interpolation_coefficients[d].data[:] = coeffs[:, j, :]
        fns[pkg] = [p, m]
    load_numpy_state(fns[dt], numpy_state(fns[dj]))
    (pj, mj), (pt, mt) = fns[dj], fns[dt]
    assert np.array_equal(pt.gridpoints, pj.gridpoints)
    assert np.array_equal(pt.interpolation_coeffs, pj.interpolation_coeffs)
    assert np.array_equal(mt.gridpoints, mj.gridpoints)
    assert np.array_equal(mt.matrix, mj.matrix)
    for d, dj_ in zip(mt.grid.dimensions, mj.grid.dimensions):
        assert np.array_equal(mt.interpolation_coefficients[d],
                              mj.interpolation_coefficients[dj_])


def test_outside_point_injects_nothing_and_clipped_corners_accumulate():
    """Sinc r=2: a point 2.5 cells inside the upper x edge injects into
    x = n-4 .. n-1 with the four weights of frac 0.5, and a point outside
    the grid injects nothing; at 1.5 cells inside, of its corners x = n-3
    .. n the last clips onto n-1 and adds to it."""
    n = 10
    grid = dt.Grid(shape=(n, n), extent=(n - 1., n - 1.), dtype=np.float64)
    g = dt.Function(name='g', grid=grid, space_order=2)
    q = dt.SparseFunction(name='q', grid=grid, npoint=2,
                          interpolation='sinc', r=2,
                          coordinates=[[n - 2.5, 4.], [n + 0.5, 4.]])
    q.data[:] = 1.
    dt.Operator(q.inject(field=g, expr=q)).apply()
    offs, ws, _ = q.interpolator.dim_weights(
        torch.tensor([0.5], dtype=torch.float64))
    w = {o: float(x) for o, x in zip(offs, ws)}
    col = np.array(g.data)[:, 4]
    assert np.allclose(col[n - 4:n - 1], [w[-1], w[0], w[1]], rtol=1e-14)
    assert np.isclose(col[n - 1], w[2], rtol=1e-14)
    assert np.isclose(np.array(g.data).sum(), sum(w.values()) * 1., 1e-14)
    q2 = dt.SparseFunction(name='q2', grid=grid, npoint=1,
                           interpolation='sinc', r=2,
                           coordinates=[[n - 1.5, 4.]])
    g2 = dt.Function(name='g2', grid=grid, space_order=2)
    q2.data[:] = 1.
    dt.Operator(q2.inject(field=g2, expr=q2)).apply()
    col = np.array(g2.data)[:, 4]
    assert np.isclose(col[n - 1], w[1] + w[2], rtol=1e-14)


def model_state(s):
    """The functions of a solver's state: the model's physical parameters
    that are Functions, its damping, the source and receivers."""
    m = s.model
    fns = [f for f in m.physical_params().values()
           if getattr(f, 'is_Function', False)]
    if getattr(m.damp, 'is_Function', False):
        fns.append(m.damp)
    return fns + [s.geometry.src, s.geometry.rec]


@pytest.mark.parametrize('kind', ['acoustic', 'elastic'])
def test_forward_with_sinc_matches_devito_tpu(kind):
    kw = dict(shape=(30, 32), spacing=(15., 15.), tn=150., space_order=4,
              nbl=10, dtype=np.float64)
    solvers = []
    for pkg in (st_, sj_):
        if kind == 'acoustic':
            s = pkg.acoustic_setup(interpolation='sinc', r=4, **kw)
        else:
            s = pkg.elastic_setup(**kw)
            s.geometry = pkg.setup_geometry(s.model, kw['tn'],
                                            interpolation='sinc')
        assert s.geometry.rec.interpolator.r == 4
        solvers.append(s)
    st, sj = solvers
    load_numpy_state(model_state(st), numpy_state(model_state(sj)))
    got, want = (s.forward()[:2] for s in solvers)
    for a, b in zip(got, want):
        assert_close(a.data, b.data, 1e-10)
