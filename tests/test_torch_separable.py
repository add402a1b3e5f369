"""Separable (tensor-product) interpolation through devito_tpu_torch,
against its own gather and against devito_tpu.

The cases of tests/test_separable.py: a surface grid under linear and
sinc weights at SO=8, permuted point order, points outside the grid, the
linear combinations ``2u + 0.5 u.dx`` and ``u.dx + u.dy + u.dz`` (the
shape of elastic's ``div(v)``), a random cloud and a small set that do not
factorise, and ``linear_terms``. Each problem is built separately in each
package from the same seeded numpy state. fp32: the port's separable
records within 2e-5 x max of its gather's and of devito_tpu's separable
ones (the sums run in other orders); fp64: rtol 1e-12. The band-limited
contraction equals the contraction of the whole field within 1e-13 x max
(fp64).
"""

import numpy as np
import pytest
import torch

import devito_tpu as dj
import devito_tpu_torch as dt
from devito_tpu.models.seismic.source import (Receiver as RecJ,
                                              TimeAxis as TAJ)
from devito_tpu_torch.models.seismic.source import (Receiver as RecT,
                                                    TimeAxis as TAT)
from devito_tpu_torch.operations.separable import (
    separable_geometry, linear_terms, to_device, contract, Separable)

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

SHAPE, EXTENT = (24, 20, 16), (230., 190., 150.)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def surface(xs, ys, z):
    X, Y = np.meshgrid(xs, ys, indexing='ij')
    return np.stack([X.ravel(), Y.ravel(), np.full(X.size, z)], axis=1)


SURFACE = surface(np.linspace(5., 220., 40), np.linspace(5., 180., 32), 75.)


def record(pkg, coords, sep, interp='linear', expr_of=None, so=4,
           dtype=np.float32, monkeypatch=None):
    """The receiver rows of 8 steps of a diffusion with the receivers
    interpolating ``expr_of(u)`` (u by default), in package ``pkg``, with
    the separable path on (``sep``) or off."""
    if pkg is dt:
        ctx = dt.switchconfig(separable=sep)
        Rec, TA = RecT, TAT
    else:
        monkeypatch.setenv('DEVITO_TPU_SEPARABLE', '1' if sep else '0')
        ctx = dj.switchconfig()
        Rec, TA = RecJ, TAJ
    with ctx:
        init = np.random.default_rng(7).random((2,) + SHAPE)
        grid = pkg.Grid(shape=SHAPE, extent=EXTENT, dtype=dtype)
        u = pkg.TimeFunction(name='u', grid=grid, space_order=so)
        u.data[:] = init
        kw = {'interpolation': interp} if interp != 'linear' else {}
        rec = Rec(name='rec', grid=grid, time_range=TA(start=0, stop=10,
                                                         step=1),
                  npoint=len(coords), coordinates=coords, **kw)
        expr = expr_of(u) if expr_of is not None else u
        op = pkg.Operator([pkg.Eq(u.forward, u + 0.1 * u.laplace),
                           rec.interpolate(expr=expr)])
        op.apply(time_M=8)
        return np.array(rec.data, dtype=np.float64)


def close(got, want, rtol):
    assert got.shape == want.shape and np.abs(want).max() > 0
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), err


def three_ways(coords, monkeypatch, rtol=2e-5, **kw):
    """The port's separable rows, held against its gather's and against
    devito_tpu's separable rows."""
    sep = record(dt, coords, True, **kw)
    close(sep, record(dt, coords, False, **kw), rtol)
    close(sep, record(dj, coords, True, monkeypatch=monkeypatch, **kw), rtol)
    return sep


@pytest.mark.parametrize('interp', ['linear', 'sinc'])
def test_surface_grid_matches_gather(monkeypatch, interp):
    three_ways(SURFACE, monkeypatch, interp=interp, so=8)


def test_permuted_point_order(monkeypatch):
    perm = np.random.default_rng(3).permutation(len(SURFACE))
    three_ways(SURFACE[perm], monkeypatch, rtol=2e-6)


def test_out_of_bounds_points_contribute_zero(monkeypatch):
    # one x-plane beyond the domain: those slots read zero, as the gather's
    # validity mask gives
    xs = np.concatenate([np.linspace(5., 220., 39), [400.]])
    sep = three_ways(surface(xs, np.linspace(5., 180., 32), 75.),
                     monkeypatch, rtol=2e-6)
    assert np.abs(sep.reshape(sep.shape[0], 40, 32)[:, -1, :]).max() == 0


@pytest.mark.parametrize('expr_of', [
    lambda u: 2.0 * u + 0.5 * u.dx,
    lambda u: u.dx + u.dy + u.dz,       # a divergence's shape (elastic)
], ids=['2u+0.5dx', 'div'])
def test_linear_combination_expr(monkeypatch, expr_of):
    three_ways(SURFACE, monkeypatch, expr_of=expr_of)


@pytest.mark.parametrize('interp', ['linear', 'sinc'])
def test_fp64_separable_equals_gather_and_devito_tpu(monkeypatch, interp):
    three_ways(SURFACE, monkeypatch, rtol=1e-12, interp=interp, so=8,
               dtype=np.float64)


def _rec(npoint, coords, interp='linear'):
    grid = dt.Grid(shape=SHAPE, extent=EXTENT)
    kw = {'interpolation': interp} if interp != 'linear' else {}
    return RecT(name='rec', grid=grid, time_range=TAT(start=0, stop=10,
                                                      step=1),
                npoint=npoint, coordinates=coords, **kw)


def test_random_cloud_not_separable():
    coords = np.random.default_rng(0).random((2048, 3)) * [220., 180., 140.]
    assert separable_geometry(_rec(2048, coords), {}) is None


def test_small_sets_skip_factorization():
    coords = surface(np.linspace(5., 220., 8), np.linspace(5., 180., 8), 75.)
    assert separable_geometry(_rec(64, coords), {}) is None  # < min_points


def test_linear_terms_decomposition():
    grid = dt.Grid(shape=(8, 8, 8))
    u = dt.TimeFunction(name='u', grid=grid, space_order=2)
    v = dt.Function(name='v', grid=grid, space_order=2)
    terms = linear_terms((2 * u + 0.5 * v).evaluate)
    assert terms is not None and len(terms) == 2
    assert sorted(c for c, _ in terms) == [0.5, 2.0]
    assert linear_terms((u * v).evaluate) is None


@pytest.mark.parametrize('interp', ['linear', 'sinc'])
def test_band_contraction_equals_the_whole_field(interp):
    """The band of each weight matrix's nonzero rows, contracted with the
    band of the field, equals the whole matrices contracted with the whole
    field (1e-13 x max, fp64); for a surface grid the z band is 2 planes
    under linear weights and 2r = 4 under sinc of radius 2."""
    rec = _rec(len(SURFACE), SURFACE, interp)
    type(rec)._coords_host = SURFACE.astype(np.float64)
    geo = separable_geometry(rec, {})
    band = to_device(geo, torch.device('cpu'))
    whole = Separable(tuple(torch.from_numpy(M.astype(np.float64))
                            for M in geo['M']), (0, 0, 0), band.order,
                      band.code)
    field = torch.from_numpy(np.random.default_rng(2).standard_normal(SHAPE))
    sub = field[tuple(slice(lo, lo + M.shape[0])
                      for lo, M in zip(band.lo, band.M))]
    got = contract(sub, band._replace(M=tuple(M.double() for M in band.M)))
    want = contract(field, whole)
    assert band.M[2].shape[0] == (2 if interp == 'linear' else 4)
    assert band.order[0] == 2                    # z: one distinct position
    close(got.numpy(), want.numpy(), 1e-13)


def test_separable_path_builds_no_gather_geometry(monkeypatch):
    """When the separable path serves an interpolation, the run builds no
    gather geometry for it; with the switch off it does."""
    from devito_tpu_torch.compiler import executor
    built = []
    orig = executor._sparse_geometry
    monkeypatch.setattr(executor, '_sparse_geometry',
                        lambda sf, *a: built.append(sf.name) or orig(sf, *a))
    record(dt, SURFACE, True)
    assert built == []
    record(dt, SURFACE, False)
    assert built == ['rec']


def test_geometry_rides_the_arguments():
    """``Operator.arguments`` carries ``rec_sep``: the band of each axis
    and the point map (None: the coordinates are in product order)."""
    grid = dt.Grid(shape=SHAPE, extent=EXTENT)
    u = dt.TimeFunction(name='u', grid=grid, space_order=4)
    rec = RecT(name='rec', grid=grid, time_range=TAT(start=0, stop=10,
                                                     step=1),
               npoint=len(SURFACE), coordinates=SURFACE)
    op = dt.Operator([dt.Eq(u.forward, u), rec.interpolate(expr=u)])
    bufs, _ = op.arguments(time_M=2)
    sep = bufs['rec_sep']
    assert [M.shape[1] for M in sep.M] == [40, 32, 1] and sep.code is None
    assert sep.M[2].shape[0] == 2 and op.separable_seconds > 0
    with dt.switchconfig(separable=False):
        assert 'rec_sep' not in op.arguments(time_M=2)[0]
