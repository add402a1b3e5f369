"""The seismic solvers on a sharded grid through devito_tpu_torch, against
its unsharded runs and devito_tpu's (tests/test_distributed_matrix.py's
halo='auto' cases).

The topology is attached to the model's grid after the set-up, as
devito_tpu's tests attach it. Stated tolerances: the port's sharded run
bit-equal to its unsharded run for wavefields, receivers within 1e-13 x max
(the shards' partial sums add in another order); fp64 rtol 1e-10 (x max)
against devito_tpu's unsharded run.
"""

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu.models import seismic as sj  # noqa: E402
from devito_tpu_torch.models import seismic as st  # noqa: E402
from devito_tpu_torch.parallel import halo as ht  # noqa: E402
from devito_tpu_torch.parallel.distributor import Distributor  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

TOL = 1e-10


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


@pytest.fixture
def explicit(monkeypatch):
    """The operators that took the explicit halo path, as they build their
    ShardedRunner."""
    built = []
    init = ht.ShardedRunner.__init__

    def record(self, op):
        init(self, op)
        built.append(op)
    monkeypatch.setattr(ht.ShardedRunner, '__init__', record)
    return built


def shard(grid, topology):
    n = int(np.prod(topology))
    grid._distributor = Distributor(grid, topology=topology,
                                    devices=[torch.device('cpu')] * n)


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def same(got, ref, records=()):
    for k, (g, r) in enumerate(zip(got, ref)):
        if k in records:
            close(g, r, 1e-13)
        else:
            assert np.array_equal(g, r), k


KINDS = {
    'acoustic': lambda s: s.acoustic_setup(
        shape=(28, 28), spacing=(10., 10.), tn=80., nbl=6, space_order=4,
        dtype=np.float64),
    'tti': lambda s: s.tti_setup(
        shape=(24, 24), spacing=(10., 10.), tn=60., nbl=4, space_order=4,
        dtype=np.float64),
    'elastic': lambda s: s.elastic_setup(
        shape=(24, 24), spacing=(10., 10.), tn=60., nbl=4, space_order=4,
        dtype=np.float64),
    'viscoacoustic': lambda s: s.viscoacoustic_setup(
        shape=(24, 24), spacing=(10., 10.), tn=60., nbl=4, space_order=4,
        dtype=np.float64),
    'viscoelastic': lambda s: s.viscoelastic_setup(
        shape=(24, 24), spacing=(10., 10.), tn=50., nbl=4, space_order=4,
        dtype=np.float64),
    'self_adjoint': lambda s: s.sa_setup(
        shape=(24, 24), spacing=(10., 10.), tn=60., npad=4, space_order=4,
        dtype=np.float64),
}


def forward(seis, kind, topology=None):
    solver = KINDS[kind](seis)
    if topology:
        shard(solver.model.grid, topology)
    out = solver.forward()
    return [np.array(f.data) for f in out[:-1] if hasattr(f, 'data')]


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_solver_forward_sharded_equals_unsharded(kind, explicit):
    """Every solver's forward at (2, 2) takes the explicit path, CIRE's
    temporaries (computed into the halo) and all, and equals the
    unsharded run to the bit: each outermost shard computes a halo-
    extended region past the domain as the whole run does."""
    ref = forward(st, kind)
    got = forward(st, kind, (2, 2))
    assert explicit
    same(got, ref)


def test_acoustic_matches_devito_tpu():
    close(forward(st, 'acoustic', (4, 2))[0],
          forward(sj, 'acoustic')[0])


def acoustic3d(seis, topology=None):
    solver = seis.acoustic_setup(shape=(16, 16, 16), spacing=(10.,) * 3,
                                 tn=50., nbl=4, space_order=4,
                                 dtype=np.float64)
    if topology:
        shard(solver.model.grid, topology)
    rec, u, _ = solver.forward()
    return np.array(rec.data), np.array(u.data)


@pytest.mark.parametrize('topology', [(2, 2, 2), (4, 2, 1), (1, 2, 4)])
def test_acoustic_3d(topology, explicit):
    ref = acoustic3d(st)
    got = acoustic3d(st, topology)
    assert explicit
    same(got, ref, records=(0,))
    if topology == (4, 2, 1):
        rj, uj = acoustic3d(sj)
        close(got[0], rj)
        close(got[1], uj)


def acoustic_save(seis, topology=None):
    solver = KINDS['acoustic'](seis)
    if topology:
        shard(solver.model.grid, topology)
    rec, u, _ = solver.forward(save=True)
    return np.array(rec.data), np.array(u.data)


@pytest.mark.parametrize('topology', [(4, 2), (2, 2)])
def test_acoustic_save(topology, explicit):
    """save=True: the whole history is cut into shards and written back."""
    ref = acoustic_save(st)
    got = acoustic_save(st, topology)
    assert explicit
    same(got, ref, records=(0,))
    if topology == (2, 2):
        for g, w in zip(got, acoustic_save(sj)):
            close(g, w)


def born(seis, topology=None):
    solver = KINDS['acoustic'](seis)
    if topology:
        shard(solver.model.grid, topology)
    pkg = dt if seis is st else dj
    dm = pkg.Function(name='dm', grid=solver.model.grid, space_order=0)
    dm.data[dm.data.shape[0] // 2:, :] = 0.2
    return np.array(solver.jacobian(dm)[0].data)


@pytest.mark.parametrize('topology', [(4, 2), (2, 2)])
def test_born(topology, explicit):
    ref = born(st)
    got = born(st, topology)
    assert explicit and np.abs(ref).max() > 0
    close(got, ref, 1e-13)
    if topology == (4, 2):
        close(got, born(sj))


def uneven(seis, topology=None):
    solver = seis.acoustic_setup(shape=(17, 15), spacing=(10., 10.),
                                 tn=80., nbl=6, space_order=4,
                                 dtype=np.float64)
    if topology:
        shard(solver.model.grid, topology)
    with (dt if seis is st else dj).switchconfig(halo='explicit'):
        rec, u, _ = solver.forward()
    return np.array(rec.data), np.array(u.data)


@pytest.mark.parametrize('topology', [(4, 2), (3, 2), (2, 2)])
def test_uneven_explicit_acoustic(topology, explicit):
    """29 x 27 (17 x 15 + nbl 6) over topologies that do not divide it: the
    last shards carry dead cells, edge-padded for the physical
    parameters."""
    ref = uneven(st)
    got = uneven(st, topology)
    assert explicit
    hr = explicit[-1]._halo_runner
    assert any(sh.live[d] < hr.parts[d][2] for sh in hr.shards
               for d in hr.parts)
    same(got, ref, records=(0,))
    if topology == (3, 2):
        for g, w in zip(got, uneven(sj)):
            close(g, w)


def test_skewed_sparse_buckets(explicit):
    """Every receiver in the (0, 0) shard's tile: one full bucket, the
    others empty."""
    def run(topo):
        grid = dt.Grid(shape=(32, 32), extent=(31., 31.), dtype=np.float64)
        if topo:
            shard(grid, topo)
        u = dt.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
        u.data[0, 16, 16] = 1.0
        u.data[0, 4, 8] = 1.0
        rec = dt.SparseTimeFunction(name='rcs', grid=grid, npoint=20, nt=8)
        rec.coordinates.data[:, 0] = np.linspace(0.5, 6.5, 20)
        rec.coordinates.data[:, 1] = np.linspace(0.5, 14.5, 20)
        eq = dt.Eq(u.forward, dt.solve(dt.Eq(u.dt2, 2.0 * u.laplace),
                                       u.forward))
        op = dt.Operator([eq, rec.interpolate(expr=u)],
                         subs=grid.spacing_map)
        op.apply(time_M=6, dt=0.05)
        return op, np.array(rec.data)
    _, ref = run(None)
    op, got = run((4, 2))
    assert explicit
    sbufs = op._halo_runner.prepare_buffers(op._prepare({'time_M': 6,
                                                         'dt': 0.05})[0])
    sizes = [len(b['rcs_own']) for b in sbufs]
    assert sizes[0] == 20 and sum(sizes) < 20 * 3
    close(got, ref, 1e-13)
    assert np.abs(ref).max() > 0


def test_combined_bc_save_sparse_subsampled(explicit):
    """Damping, a save wavefield, the source and receivers and a
    subsampled snapshot stream in one operator, at (4, 2)."""
    def run(topo):
        solver = KINDS['acoustic'](st)
        model, geometry = solver.model, solver.geometry
        grid = model.grid
        if topo:
            shard(grid, topo)
        nt = geometry.nt
        tsub = dt.ConditionalDimension('tsub', parent=grid.time_dim,
                                       factor=4)
        usnap = dt.TimeFunction(name='usnap', grid=grid, time_dim=tsub,
                                save=(nt + 3) // 4)
        u = dt.TimeFunction(name='u', grid=grid, time_order=2,
                            space_order=4, save=nt)
        from devito_tpu_torch.models.seismic.acoustic import iso_stencil
        src, rec = geometry.src, geometry.rec
        op = dt.Operator(
            list(iso_stencil(u, model, kernel='OT2')) + [
                dt.Eq(usnap, u),
                src.inject(field=u.forward,
                           expr=src * grid.time_dim.spacing ** 2 / model.m),
                rec.interpolate(expr=u)], subs=model.spacing_map)
        op.apply(dt=model.critical_dt)
        return np.array(u.data), np.array(usnap.data), np.array(rec.data)
    ref = run(None)
    got = run((4, 2))
    assert explicit
    assert np.abs(ref[1]).max() > 0 and np.abs(ref[2]).max() > 0
    same(got, ref, records=(2,))


def test_seismic_model_topology(explicit):
    """SeismicModel(topology=...) (through demo_model) with mesh-devices 4:
    the user's script unchanged but for the topology; the shot equals the
    unsharded one."""
    def shot(topology):
        model = st.demo_model('layers-isotropic', shape=(30, 34),
                              spacing=(10., 10.), nbl=6, space_order=4,
                              dtype=np.float64, topology=topology)
        geometry = st.AcquisitionGeometry(
            model, np.stack([np.linspace(0, 290, 9), np.full(9, 20.)], 1),
            np.array([[150., 20.]]), 0., 120., f0=0.010, src_type='Ricker')
        rec, u, _ = st.AcousticWaveSolver(model, geometry,
                                          space_order=4).forward()
        return model, np.array(rec.data), np.array(u.data)
    _, r0, u0 = shot(None)
    with dt.switchconfig(**{'mesh-devices': 4}):
        model, r1, u1 = shot(('*', '*'))
    assert model.grid.distributor.topology == (2, 2) and explicit
    assert np.array_equal(u1, u0)
    close(r1, r0, 1e-13)
