"""Operators of devito_tpu_torch through pickle.

The non-sharded operator cases of tests/test_pickle.py: a rerun after a
round trip, an operator with source injection and receiver interpolation,
the metadata kept, a SubDomain function and a symbolic subsampling factor;
each unpickled operator reruns to its own first run, to the bit, and to
what devito_tpu's gives on the same inputs: to the bit for the SubDomain
and subsampling cases, within 1e-5 x max for the fp32 wave and 1e-12 x
max for the fp64 acoustic shot. Besides:
the runner, its K1 plans and the bounded runners are not pickled and are
built again from the same units (build keys), and the narrow storage and
errctl settings survive the trip.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def roundtrip(obj):
    return pickle.loads(pickle.dumps(obj))


def wave(pkg, name='Kernel', opt=None):
    grid = pkg.Grid(shape=(16, 16), extent=(15., 15.))
    u = pkg.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    st = pkg.solve(u.dt2 - u.laplace, u.forward)
    return grid, u, pkg.Operator(pkg.Eq(u.forward, st),
                                 subs=grid.spacing_map, name=name, opt=opt)


def test_pickle_operator_rerun():
    out = []
    for pkg in (dj, dt):
        grid, u, op = wave(pkg)
        u.data[0, 8, 8] = 1.0
        op.apply(time_M=5, dt=0.1)
        ref = np.array(u.data)
        op2 = roundtrip(op)
        u2 = pkg.TimeFunction(name='u', grid=grid, time_order=2,
                              space_order=4)
        u2.data[0, 8, 8] = 1.0
        op2.apply(u=u2, time_M=5, dt=0.1)
        assert np.array_equal(np.array(u2.data), ref)
        out.append(ref)
    # fp32: the packages' sums run in other orders
    assert np.abs(out[1] - out[0]).max() <= 1e-5 * np.abs(out[0]).max()


def test_pickle_operator_with_sparse():
    """An acoustic forward (source injection, receiver interpolation)
    reruns after a trip to the original record; the record equals
    devito_tpu's within 1e-12 x max."""
    recs = []
    for pkg in (dj, dt):
        seis = __import__(f'{pkg.__name__}.models.seismic',
                          fromlist=['acoustic_setup'])

        def setup():
            return seis.acoustic_setup(shape=(24, 24), spacing=[12.5, 12.5],
                                       nbl=4, tn=80., space_order=4,
                                       preset='layers-isotropic',
                                       dtype=np.float64)
        solver = setup()
        op = solver.op_fwd(False)
        rec, u, _ = solver.forward()
        ref = np.array(rec.data)
        op2 = roundtrip(op)
        solver2 = setup()
        u2 = pkg.TimeFunction(name='u', grid=solver2.model.grid,
                              time_order=2, space_order=4)
        rec2 = solver2.geometry.rec
        op2.apply(src=solver2.geometry.src, rec=rec2, u=u2,
                  vp=solver2.model.vp, damp=solver2.model.damp,
                  dt=solver2.dt)
        assert np.allclose(np.array(rec2.data), ref, rtol=1e-12, atol=1e-14)
        recs.append(ref)
    assert np.abs(recs[1] - recs[0]).max() <= 1e-12 * np.abs(recs[0]).max()


def test_pickle_operator_preserves_metadata():
    _, _, op = wave(dt, name='Pkl')
    op2 = roundtrip(op)
    assert op2.name == 'Pkl'
    assert len(op2._schedule.body) == len(op._schedule.body)
    assert op2._flops_per_step == op._flops_per_step
    assert str(op2) == str(op)
    # the runner is built again, on the same unit
    assert op2._runner is not op._runner
    assert [p.key for _, p in op2.kernel_plans] == \
        [p.key for _, p in op.kernel_plans]


def test_pickle_subdomain_function_operator():
    out = []
    for pkg in (dj, dt):
        grid = pkg.Grid(shape=(10, 10), extent=(9., 9.))
        sd = pkg.SubDomain(name='pmid', spec={'x': ('middle', 2, 3),
                                              'y': ('right', 6)}, grid=grid)
        f = pkg.Function(name='fp', grid=sd)
        op = pkg.Operator(pkg.Eq(f, f + 1))
        op.apply()
        assert np.all(np.asarray(f.data) == 1)
        op2 = roundtrip(op)
        op2.apply(fp=f)
        assert np.all(np.asarray(f.data) == 2)
        out.append(np.array(f.data))
    assert np.array_equal(out[0], out[1])


def test_pickle_conditional_symbolic_factor():
    out = []
    for pkg in (dj, dt):
        grid = pkg.Grid(shape=(6, 6))
        fact = pkg.Constant(name='pfact', dtype=np.int32, value=3)
        cd = pkg.ConditionalDimension(name='pcd', parent=grid.time_dim,
                                      factor=fact)
        u = pkg.TimeFunction(name='up', grid=grid, time_order=0)
        usave = pkg.TimeFunction(name='usavep', grid=grid, time_dim=cd,
                                 save=4)
        op = pkg.Operator([pkg.Eq(u, u + 1), pkg.Eq(usave, u)])
        op2 = roundtrip(op)
        op2.apply(time=7, dt=1, up=u, usavep=usave)
        assert np.all(np.asarray(usave.data)[1] == 4)
        out.append(np.array(usave.data))
    assert np.array_equal(out[0], out[1])


def test_pickle_keeps_storage_errctl_and_drops_bounded_runners():
    """A narrow-storage, errctl operator after a bounded apply: the trip
    leaves out the bounded runners, keeps the storage map and the scan,
    and the copy reruns as the original, bounds included."""
    opt = ('advanced', {'storage-dtype': 'bfloat16', 'errctl': 'max'})
    grid, u, op = wave(dt, opt=opt)
    u.data[0, 8, 8] = 1.0
    op.apply(time_M=5, dt=0.1, x_m=2, x_M=12)
    assert op._bounded_cache
    state = op.__getstate__()
    assert '_runner' not in state and '_bounded_cache' not in state
    op2 = roundtrip(op)
    assert op2._storage == {'u': torch.bfloat16} and op2._errctl == ('u',)
    assert op2._bounded_cache == {}
    outs = []
    for o in (op, op2):
        w = dt.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
        w.data[0, 8, 8] = 1.0
        o.apply(u=w, time_M=5, dt=0.1, x_m=2, x_M=12)
        outs.append(np.array(w.data))
    assert np.array_equal(outs[0], outs[1])
    assert [p.storage for _, p in op2.kernel_plans] == [[torch.bfloat16] * 3]


def test_pickle_operator_sharded_rerun():
    """An operator built on a sharded grid, pickled and re-applied: the
    copy takes the explicit halo path again (its sharded runner is not
    pickled, it is built at the first apply) and reruns the unsharded
    trajectory to the bit, and devito_tpu's within 1e-5 x max (fp32)."""
    from devito_tpu_torch.parallel.distributor import Distributor
    from devito_tpu.parallel.distributor import Distributor as DistJ

    def run(pkg, topology=None, trip=False):
        grid = pkg.Grid(shape=(32, 32), extent=(31., 31.))
        if topology:
            n = int(np.prod(topology))
            grid._distributor = (
                Distributor(grid, topology, devices=[torch.device('cpu')] * n)
                if pkg is dt else
                DistJ(grid, topology=topology, devices=jax.devices()[:n]))
        u = pkg.TimeFunction(name='u', grid=grid, time_order=2,
                             space_order=4)
        op = pkg.Operator(pkg.Eq(u.forward, pkg.solve(u.dt2 - u.laplace,
                                                      u.forward)),
                          subs=grid.spacing_map)
        if trip:
            op.apply(time_M=1, dt=0.1)
            assert '_halo_runner' not in op.__getstate__()
            op = roundtrip(op)
            u = pkg.TimeFunction(name='u', grid=grid, time_order=2,
                                 space_order=4)
        u.data[0, 16, 16] = 1.0
        op.apply(u=u, time_M=5, dt=0.1)
        return op, np.array(u.data)

    _, ref = run(dt)
    op2, got = run(dt, (4, 2), trip=True)
    assert op2._halo_runner is not None
    assert op2._grid.distributor.topology == (4, 2)
    assert np.array_equal(got, ref)
    want = run(dj, (4, 2))[1]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
