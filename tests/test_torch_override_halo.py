"""Function overrides of another halo through devito_tpu_torch: ``apply(f=g)``
where ``g`` has the shape and dtype of the Operator's ``f`` but another
halo. ``solver.jacobian(dm)`` binds a ``dm`` of space order 1 to Born's
``dm`` of space order 0 (tests/test_distributed_matrix.py
``test_born_matrix``'s setup: 28^2, nbl 6, SO 4), read-only; a
TimeFunction of a wider halo is written, its rows back in it.

The port runs such an override on a runner planned for its layout
(``Operator._relaid``), so the override's own domain is read and written:
its result equals the run with a function of the Operator's own layout
holding the same data. devito_tpu checks only shape and dtype and reads
the override's buffer at the Operator's halo, one point off here; its
result with an override of the Operator's own layout is the reference.

Stated tolerance (fp64): rtol 1e-10 x max against devito_tpu; the port's
override runs bit-equal to its own-layout runs, sharded or not.
"""

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu  # noqa: E402
from devito_tpu.models import seismic as sj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu_torch.exceptions import InvalidArgument  # noqa: E402
from devito_tpu_torch.kernels import stencil as K  # noqa: E402
from devito_tpu_torch.models import seismic as st  # noqa: E402
from devito_tpu_torch.parallel.distributor import Distributor  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

TOL = 1e-10
#: dm's domain data (28 + 2 x nbl 6 = 40 points an axis)
DM = np.random.default_rng(7).standard_normal((40, 40))


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def born(pkg, seis, so, data, topology=None):
    """Born's record of ``dm`` at space order ``so`` holding ``data``, and
    the solver."""
    solver = seis.acoustic_setup(shape=(28, 28), spacing=(10., 10.), tn=80.,
                                 nbl=6, space_order=4, dtype=np.float64)
    if topology is not None:
        g = solver.model.grid
        g._distributor = Distributor(g, topology=topology,
                                     devices=[torch.device('cpu')] * 4)
    dm = pkg.Function(name='dm', grid=solver.model.grid, space_order=so)
    dm.data[:] = data
    return np.array(solver.jacobian(dm)[0].data), solver


_ref = {}


def reference():
    """devito_tpu's Born record with a dm of Born's own layout."""
    if 'born' not in _ref:
        _ref['born'] = born(devito_tpu, sj, 0, DM)[0]
    return _ref['born']


@pytest.mark.parametrize('so', [1, 4])
def test_born_dm_override_matches_devito_tpu(so):
    got, solver = born(dt, st, so, DM)
    assert np.abs(got).max() > 0
    close(got, reference())
    own, _ = born(dt, st, 0, DM)
    assert np.array_equal(got, own)
    op = solver.op_born()
    assert op.relayouts == 1 and len(op._layout_ops) == 1


def test_born_dm_override_sharded_matches_devito_tpu():
    """On a (2, 2) mesh of four shards: the override runs sharded, on its
    own layout's ShardedRunner, bit-equal to the port's serial run."""
    with dt.switchconfig(**{'mesh-devices': 4}):
        got, solver = born(dt, st, 1, DM, topology=(2, 2))
    op = solver.op_born()
    relaid, = op._layout_ops.values()
    assert relaid._halo_runner is not None and op.last_exchange['copies'] > 0
    close(got, reference())
    assert np.array_equal(got, born(dt, st, 1, DM)[0])


def test_born_matrix_setup_serial_and_sharded_agree():
    """tests/test_distributed_matrix.py test_born_matrix through the port:
    dm (space order 1) set to 0.2 on half the grid, serial against (2, 2)
    under halo='auto'."""
    data = np.zeros((40, 40))
    data[20:, :] = 0.2
    ref, _ = born(dt, st, 1, data)
    with dt.switchconfig(**{'mesh-devices': 4}, halo='auto'):
        got, _ = born(dt, st, 1, data, topology=(2, 2))
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-5


def test_reference_reads_an_override_at_the_operator_s_halo():
    """devito_tpu's own override run equals its run with the data shifted
    by the halo difference: it reads the override's buffer at the
    Operator's halo. The port reads the override's own domain."""
    shifted = np.zeros_like(DM)
    shifted[1:, 1:] = DM[:-1, :-1]
    got, _ = born(devito_tpu, sj, 1, DM)
    close(got, born(devito_tpu, sj, 0, shifted)[0])
    assert np.abs(got - reference()).max() > 1e-3 * np.abs(got).max()


def diffusion(pkg, so_over=None, topology=None):
    """Ten steps of ``u.dt = m u.laplace`` (SO 2, fp64) on 20 x 24; with
    ``so_over`` the run writes an override of that space order. Returns
    (the written field's rows, the Operator, the written function)."""
    g = pkg.Grid(shape=(20, 24), extent=(19., 23.), dtype=np.float64)
    if topology is not None:
        g._distributor = Distributor(g, topology=topology,
                                     devices=[torch.device('cpu')] * 4)
    u = pkg.TimeFunction(name='u', grid=g, space_order=2)
    m = pkg.Function(name='m', grid=g, space_order=0)
    rng = np.random.default_rng(3)
    m.data[:] = 1 + rng.random((20, 24))
    u0 = rng.standard_normal((20, 24))
    op = pkg.Operator(pkg.Eq(u.forward, pkg.solve(u.dt - m * u.laplace,
                                                  u.forward)))
    w = u
    if so_over is not None:
        w = pkg.TimeFunction(name='u', grid=g, space_order=so_over)
    w.data[0] = u0
    op.apply(time_M=9, dt=0.01, **({} if w is u else {'u': w}))
    return np.array(w.data), op, w


def test_written_override_of_a_wider_halo_matches_devito_tpu():
    want, _, _ = diffusion(devito_tpu)
    got, op, w = diffusion(dt, so_over=6)
    assert w.halo == ((6, 6), (6, 6))
    close(got, want)
    own, _, _ = diffusion(dt)
    assert np.array_equal(got, own)
    # the override's halo stays zero: the update wrote its domain only
    full = np.array(w.data_with_halo)
    assert not full[:, :6].any() and not full[:, -6:].any()
    with dt.switchconfig(**{'mesh-devices': 4}):
        sharded, _, _ = diffusion(dt, so_over=6, topology=(2, 2))
    assert np.array_equal(sharded, own)


def test_own_functions_keep_their_runner_and_plans():
    """After overrides of two other layouts, the Operator's own apply runs
    on its first runner: the same plan objects, no plan made; the same
    layout again reuses its relaid runner."""
    g = dt.Grid(shape=(20, 24), extent=(19., 23.), dtype=np.float64)
    u = dt.TimeFunction(name='u', grid=g, space_order=2)
    op = dt.Operator(dt.Eq(u.forward, u + 0.1 * u.laplace))
    runner, plans = op._runner, [p for _, p in op.kernel_plans]
    for so in (4, 4, 6):
        w = dt.TimeFunction(name='u', grid=g, space_order=so)
        op.apply(u=w, time_M=2, dt=1.)
    assert op.relayouts == 2 and len(op._layout_ops) == 2
    made = dict(K.designs), K.declines
    op.apply(time_M=2, dt=1.)
    assert (dict(K.designs), K.declines) == made
    assert op._runner is runner
    assert all(a is b for a, b in zip([p for _, p in op.kernel_plans],
                                      plans))
    # relaid plans launch as any plan: the relaid runner holds its own
    for relaid in op._layout_ops.values():
        assert all(p is not q for (_, p), q in zip(relaid.kernel_plans,
                                                   plans))


def test_override_with_too_narrow_a_halo_raises():
    g = dt.Grid(shape=(20, 24), extent=(19., 23.), dtype=np.float64)
    u = dt.TimeFunction(name='u', grid=g, space_order=8)
    op = dt.Operator(dt.Eq(u.forward, u + 0.1 * u.laplace))
    w = dt.TimeFunction(name='u', grid=g, space_order=2)
    with pytest.raises(InvalidArgument, match='reaches past'):
        op.apply(u=w, time_M=2, dt=1.)


def test_pickled_operator_takes_the_relaid_path():
    import pickle
    g = dt.Grid(shape=(20, 24), extent=(19., 23.), dtype=np.float64)
    u = dt.TimeFunction(name='u', grid=g, space_order=2)
    u.data[0] = np.random.default_rng(5).standard_normal((20, 24))
    op = dt.Operator(dt.Eq(u.forward, u + 0.1 * u.laplace))
    w = dt.TimeFunction(name='u', grid=g, space_order=4)
    op.apply(u=w, time_M=2, dt=1.)
    op2 = pickle.loads(pickle.dumps(op))
    assert not getattr(op2, '_layout_ops', None)
    w2 = dt.TimeFunction(name='u', grid=g, space_order=4)
    w2.data[0] = u.data[0]
    op2.apply(u=w2, time_M=2, dt=1.)
    op.apply(time_M=2, dt=1.)
    assert np.array_equal(np.array(w2.data), np.array(u.data))
