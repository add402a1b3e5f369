"""Multi-device runs of devito_tpu_torch against devito_tpu
(tests/test_parallel.py's cases) and the Distributor.

devito_tpu runs on its 8 virtual CPU devices (conftest), the port on
shards on 'cpu' (``mesh-devices`` 8, or a Distributor given 'cpu' eight
times). Stated tolerances: fp64 rtol 1e-10 (x max) against devito_tpu;
the port's sharded fields bit-equal to its unsharded run, its receivers
within 1e-14 x max (the shards' partial sums add in another order).
"""

import pickle

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu.parallel.distributor import Distributor as DistJ  # noqa
from devito_tpu_torch.parallel import distributor as D  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

TOL = 1e-10


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


@pytest.fixture
def eight():
    with dt.switchconfig(**{'mesh-devices': 8}):
        yield


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def mkgrid(pkg, shape, topology=None):
    grid = pkg.Grid(shape=shape, extent=tuple(float(s - 1) for s in shape),
                    dtype=np.float64)
    if topology is not None:
        n = int(np.prod(topology))
        grid._distributor = (
            DistJ(grid, topology=topology, devices=jax.devices()[:n])
            if pkg is dj else
            D.Distributor(grid, topology=topology,
                          devices=[torch.device('cpu')] * n))
    return grid


def acoustic_once(pkg, grid, nt=8, dt_=0.05):
    u = pkg.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    vp = pkg.Function(name='vp', grid=grid)
    vp.data[:] = 1.5
    st = pkg.solve((1 / (vp * vp)) * u.dt2 - u.laplace, u.forward)
    u.data[(0,) + tuple(s // 2 for s in grid.shape)] = 1.0
    op = pkg.Operator(pkg.Eq(u.forward, st), subs=grid.spacing_map)
    op.apply(time_M=nt - 1, dt=dt_)
    return op, np.array(u.data)


# -- the Distributor -----------------------------------------------------------

def test_compute_dims():
    from devito_tpu.parallel.distributor import compute_dims
    for n, nd in ((8, 2), (6, 2), (8, 3), (1, 2), (12, 3), (7, 2), (16, 1)):
        assert D.compute_dims(n, nd) == compute_dims(n, nd)
    assert D.compute_dims(8, 2) == (4, 2)
    assert D.compute_dims(8, 3) == (2, 2, 2)


@pytest.mark.parametrize('shape,topology', [
    ((32, 32), None), ((32, 32), ('*', '*')), ((32, 32), (2, '*')),
    ((16, 16, 16), None), ((16, 16, 16), ('*', '*', 1)),
    ((16, 16, 16), ('*', 2, '*')), ((24,), None)])
def test_topology_and_shortcuts_equal_devito_tpu(shape, topology, eight):
    """The default topology (the outer two dimensions sharded, the
    innermost whole) and the '*' shortcuts give devito_tpu's."""
    gt = dt.Grid(shape=shape, topology=topology) if topology else \
        dt.Grid(shape=shape)
    gj = dj.Grid(shape=shape)
    want = DistJ(gj, topology=topology, devices=jax.devices()[:8])
    got = D.Distributor(gt, topology=topology)
    assert got.topology == want.topology
    assert got.nprocs == want.nprocs == 8
    assert got.axis_names == want.axis_names
    assert got.shape_local == want.shape_local
    assert got.mesh.shape == want.topology
    if topology:
        assert gt.is_distributed and gt.distributor.topology == want.topology
        assert gt.shape_local == want.shape_local


def test_mesh_devices_placement():
    """mesh-devices N makes N shards, placed in turn on the visible devices
    of configuration['device']: all on 'cpu' here; the default, one a
    visible device."""
    with dt.switchconfig(**{'mesh-devices': 4}):
        assert D.mesh_devices() == [torch.device('cpu')] * 4
        g = dt.Grid(shape=(8, 8), topology=('*', '*'))
        assert g.distributor.topology == (2, 2)
        assert set(g.distributor.devices) == {torch.device('cpu')}
    assert D.mesh_devices() == [torch.device('cpu')]
    with pytest.raises(ValueError):
        D.Distributor(dt.Grid(shape=(8, 8)), topology=(2, 2))


def test_distributor_pickles_and_rebinds(eight):
    g = dt.Grid(shape=(16, 16), topology=(4, 2))
    g2 = pickle.loads(pickle.dumps(g))
    assert g2.distributor.topology == (4, 2)
    assert g2.distributor.devices == [torch.device('cpu')] * 8
    # a mesh over a card this host does not have raises on load
    d = g.distributor
    state = d.__getstate__()
    state['_mesh'] = ['cuda:3'] * 8
    fresh = D.Distributor.__new__(D.Distributor)
    with pytest.raises(RuntimeError, match='CUDA device'):
        fresh.__setstate__(state)


# -- sharded runs --------------------------------------------------------------

@pytest.mark.parametrize('topology', [(4, 2), (2, 2), (8, 1)])
def test_sharded_matches_serial_and_devito_tpu_2d(topology):
    _, ref = acoustic_once(dt, mkgrid(dt, (32, 32)))
    op, got = acoustic_once(dt, mkgrid(dt, (32, 32), topology))
    assert op._halo_runner is not None
    assert np.array_equal(got, ref)
    close(got, acoustic_once(dj, mkgrid(dj, (32, 32), topology))[1])


def test_sharded_matches_serial_and_devito_tpu_3d():
    _, ref = acoustic_once(dt, mkgrid(dt, (16, 16, 16)))
    op, got = acoustic_once(dt, mkgrid(dt, (16, 16, 16), (4, 2, 1)))
    assert op._halo_runner is not None and len(op._halo_runner.shards) == 8
    assert np.array_equal(got, ref)
    close(got, acoustic_once(dj, mkgrid(dj, (16, 16, 16), (4, 2, 1)))[1])


def test_grid_topology_through_mesh_devices(eight):
    """Grid(topology=('*', '*')) with mesh-devices 8: the user's script
    unchanged but for the topology."""
    _, ref = acoustic_once(dt, dt.Grid(shape=(32, 32), extent=(31., 31.),
                                       dtype=np.float64))
    g = dt.Grid(shape=(32, 32), extent=(31., 31.), dtype=np.float64,
                topology=('*', '*'))
    assert g.distributor.topology == (4, 2)
    op, got = acoustic_once(dt, g)
    assert op._halo_runner is not None
    assert np.array_equal(got, ref)


def sparse_ops(pkg, grid, nt=6):
    u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
    src = pkg.SparseTimeFunction(name='src', grid=grid, npoint=2, nt=nt,
                                 coordinates=[[11., 11.], [5.5, 17.2]])
    src.data[:] = 1.0
    rec = pkg.SparseTimeFunction(name='rec', grid=grid, npoint=3, nt=nt,
                                 coordinates=[[11., 11.], [6., 17.],
                                              [20., 3.]])
    op = pkg.Operator([pkg.Eq(u.forward, 0.5 * u),
                       src.inject(field=u.forward, expr=src),
                       rec.interpolate(expr=u)])
    op.apply(time_M=nt - 2, dt=1.0)
    return op, np.array(u.data), np.array(rec.data)


@pytest.mark.parametrize('topology', [(2, 2), (4, 2)])
def test_sharded_sparse_ops(topology):
    """Injection and interpolation with owner-bucketed points: the
    straddling points' corners split over several shards."""
    _, u0, r0 = sparse_ops(dt, mkgrid(dt, (24, 24)))
    op, u1, r1 = sparse_ops(dt, mkgrid(dt, (24, 24), topology))
    hr = op._halo_runner
    assert hr is not None
    assert np.array_equal(u1, u0)
    close(r1, r0, 1e-14)
    _, uj, rj = sparse_ops(dj, mkgrid(dj, (24, 24), topology))
    close(u1, uj)
    close(r1, rj)


def test_owner_buckets_equal_devito_tpu():
    from devito_tpu.parallel.halo import bucket_sparse_points as bj
    from devito_tpu_torch.parallel.halo import bucket_sparse_points as bt
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 31, (40, 2))
    for topo in ((2, 2), (4, 2), (3, 2), (1, 8)):
        got = bt(coords, mkgrid(dt, (32, 32)), topo, 2)
        want = bj(coords, mkgrid(dj, (32, 32)), topo, 2)
        assert np.array_equal(got, want)


def test_estimate_memory_counts_the_shards():
    """A sharded apply holds the whole tensors and every shard's: the
    estimate is the unsharded one (devito_tpu's, whose shards are the
    global array's parts) plus the shards' local tensors, a replicated
    function's copy on every shard but the first."""
    from devito_tpu_torch.parallel.halo import local_space, partitions

    def op_on(topology):
        grid = mkgrid(dt, (30, 26), topology)
        u = dt.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
        rec = dt.SparseTimeFunction(name='rec', grid=grid, npoint=3, nt=9)
        return dt.Operator([dt.Eq(u.forward, 0.5 * u + u.laplace),
                            rec.interpolate(expr=u)]), u, rec
    op0, _, _ = op_on(None)
    op1, u, rec = op_on((4, 2))
    parts = partitions(u.grid)
    assert local_space(u, parts) == (4 + 8 + 4, 128)
    shards = 8 * 3 * 16 * 128 * 8
    replicas = 7 * int(np.prod(rec.shape_allocated)) * 8
    assert op1.estimate_memory() == op0.estimate_memory() + shards + replicas
