"""Redistribution between decompositions (devito_tpu_torch/parallel/
redistribute.py) against devito_tpu's (tests/test_redistribute.py's
cases): the same data through both, bit-equal to each other and to the
source (a bf16 destination within bf16's rounding), and a sharded apply
on the destination's topology equal to the unsharded one.
"""

import numpy as np
import pytest
import torch

import jax

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu.parallel import redistribute as rj  # noqa: E402
from devito_tpu.parallel.distributor import Distributor as DistJ  # noqa
from devito_tpu_torch.parallel import redistribute as rt  # noqa: E402
from devito_tpu_torch.parallel.distributor import Distributor as DistT  # noqa

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def grid(pkg, shape, topology=None):
    g = pkg.Grid(shape=shape, extent=tuple(float(s - 1) for s in shape))
    if topology is not None:
        n = int(np.prod(topology))
        g._distributor = (
            DistJ(g, topology=topology, devices=jax.devices()[:n])
            if pkg is dj else
            DistT(g, topology=topology, devices=[torch.device('cpu')] * n))
    return g


def both(fn):
    """fn(pkg, redistribute) for each package: (port's, devito_tpu's)."""
    return fn(dt, rt), fn(dj, rj)


@pytest.mark.parametrize('src_topo,dst_topo', [
    ((2, 2), (4, 1)), ((4, 1), (1, 4)), ((2, 2), None), (None, (2, 4))])
def test_reshard_roundtrip(src_topo, dst_topo):
    ref = np.arange(16. * 24, dtype=np.float32).reshape(16, 24)

    def go(pkg, redistribute):
        gs, gd = grid(pkg, (16, 24), src_topo), grid(pkg, (16, 24), dst_topo)
        f = pkg.Function(name='fsrc', grid=gs, space_order=2)
        g = pkg.Function(name='fdst', grid=gd, space_order=4)
        f.data[:] = ref
        f._device_array()
        redistribute(f, g)
        f2 = pkg.Function(name='fsrc2', grid=gs, space_order=2)
        redistribute(g, f2)
        return np.asarray(g.data), np.asarray(f2.data)
    (g, f2), (gj, f2j) = both(go)
    for a in (g, f2, gj, f2j):
        assert np.array_equal(a, ref)


def test_reshard_timefunction_uneven():
    ref = np.random.RandomState(0).randn(3, 13, 16).astype(np.float32)

    def go(pkg, redistribute):
        u = pkg.TimeFunction(name='ursrc', grid=grid(pkg, (13, 16), (2, 2)),
                             time_order=2, space_order=2)
        v = pkg.TimeFunction(name='urdst', grid=grid(pkg, (13, 16), (4, 1)),
                             time_order=2, space_order=2)
        u.data[:] = ref
        redistribute(u, v)
        return np.asarray(v.data)
    got, want = both(go)
    assert np.array_equal(got, ref) and np.array_equal(want, ref)


def test_reshard_dtype_and_layout():
    """fp32 into bf16 storage: rounded to nearest even, as devito_tpu's."""
    ref = np.linspace(0, 1, 8 * 128, dtype=np.float32).reshape(8, 128)

    def go(pkg, redistribute):
        f = pkg.Function(name='flsrc', grid=grid(pkg, (8, 128)),
                         space_order=2)
        g = pkg.Function(name='fldst', grid=grid(pkg, (8, 128)),
                         space_order=2)
        g.set_storage_dtype('bfloat16')
        f.data[:] = ref
        redistribute(f, g)
        return np.asarray(g.data)
    got, want = both(go)
    assert np.allclose(got, ref, atol=4e-3)
    assert np.array_equal(got, want)


def test_reshard_shape_mismatch_raises():
    f = dt.Function(name='fmm1', grid=grid(dt, (8, 8)))
    g = dt.Function(name='fmm2', grid=grid(dt, (8, 10)))
    with pytest.raises(ValueError, match='shape mismatch'):
        rt(f, g)
    u = dt.TimeFunction(name='umm1', grid=grid(dt, (8, 8)), save=5)
    v = dt.TimeFunction(name='umm2', grid=grid(dt, (8, 8)), save=4)
    with pytest.raises(ValueError, match='shape mismatch'):
        rt(u, v)


@pytest.mark.parametrize('src_topo,dst_topo', [
    ((2, 2, 1), (4, 1, 1)), ((1, 2, 2), (2, 2, 1))])
def test_reshard_3d_topologies(src_topo, dst_topo):
    ref = np.random.RandomState(2).randn(8, 12, 16).astype(np.float32)

    def go(pkg, redistribute):
        f = pkg.Function(name='f3s', grid=grid(pkg, (8, 12, 16), src_topo),
                         space_order=2)
        g = pkg.Function(name='f3d', grid=grid(pkg, (8, 12, 16), dst_topo),
                         space_order=2)
        f.data[:] = ref
        redistribute(f, g)
        return np.asarray(g.data)
    got, want = both(go)
    assert np.array_equal(got, ref) and np.array_equal(want, ref)


def test_reshard_timefunction_save_axis():
    """A save history reshards with its time axis whole."""
    ref = np.random.RandomState(3).randn(5, 16, 16).astype(np.float32)

    def go(pkg, redistribute):
        u = pkg.TimeFunction(name='usv', grid=grid(pkg, (16, 16), (2, 2)),
                             save=5, space_order=2)
        v = pkg.TimeFunction(name='usvd', grid=grid(pkg, (16, 16), (1, 4)),
                             save=5, space_order=2)
        u.data[:] = ref
        redistribute(u, v)
        return np.asarray(v.data)
    got, want = both(go)
    assert np.array_equal(got, ref) and np.array_equal(want, ref)


def test_redistributed_function_runs_sharded():
    """A field moved onto a (1, 4) grid runs there, sharded, equal to the
    same update unsharded; its halo is zero after the move."""
    ref = np.random.RandomState(4).randn(16, 16)
    out = []
    for topo in (None, (1, 4)):
        gs, gd = grid(dt, (16, 16), (2, 2)), grid(dt, (16, 16), topo)
        f = dt.Function(name='fr', grid=gs, space_order=2)
        g = dt.Function(name='gr', grid=gd, space_order=2)
        f.data[:] = ref
        rt(f, g)
        assert g.halo_state == 'zero'
        u = dt.TimeFunction(name='ur', grid=gd, space_order=2)
        op = dt.Operator(dt.Eq(u.forward, u + g.dx))
        op.apply(time_M=2, dt=1.0, h_x=1.0, h_y=1.0)
        assert (op._halo_runner is not None) == (topo is not None)
        out.append(np.asarray(u.data))
    assert np.array_equal(out[0], out[1])
