"""The global-indexing ``Data`` view of a distributed function
(devito_tpu_torch/data.py) against numpy and against devito_tpu's sharded
``Data`` (tests/test_data_port.py's and tests/test_parallel.py's cases).

After a sharded apply both packages hand out ``Data`` for ``.data``; the
same reads and writes go to both and to a numpy copy, and all three must
agree exactly (fp32 values, no arithmetic).
"""

import numpy as np
import pytest
import torch

import jax

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu.data import Data as DataJ  # noqa: E402
from devito_tpu.parallel.distributor import Distributor as DistJ  # noqa
from devito_tpu_torch.data import Data as DataT  # noqa: E402
from devito_tpu_torch.parallel.distributor import Distributor as DistT  # noqa

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def sharded_u(pkg, topology, shape=(16, 16), seed=0):
    """u after one sharded apply of u.forward = u + 1 (device-resident):
    returns (u, the numpy reference of u.data)."""
    grid = pkg.Grid(shape=shape, extent=tuple(float(s - 1) for s in shape))
    n = int(np.prod(topology))
    grid._distributor = (
        DistJ(grid, topology=topology, devices=jax.devices()[:n])
        if pkg is dj else
        DistT(grid, topology=topology, devices=[torch.device('cpu')] * n))
    u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
    rng = np.random.default_rng(seed)
    ref = np.round(rng.standard_normal((2,) + shape), 3).astype(np.float32)
    u.data[:] = ref
    op = pkg.Operator(pkg.Eq(u.forward, u + 1))
    op.apply(time_m=0, time_M=0)
    ref[1] = ref[0] + 1
    return u, ref


READS = [
    (0, 1, 1), (1, slice(2, -2), slice(2, -2)), (0, slice(None), 5),
    (0, slice(3, None, -1), 2), (1, slice(None, None, 3), slice(1, 7)),
    (0, [1, 5, 9], 5), (1, -15, -15), (Ellipsis, 3), (1, Ellipsis),
    (0, slice(5, 1, -1), slice(None, None, -2)), (slice(None), [2, -1], 0),
    (1, np.array([[0, 3], [7, 15]]), slice(4, 9)), (0,), (-1, -1),
]


@pytest.mark.parametrize('topology', [(2, 2), (4, 2)])
def test_sharded_indexing_matches_numpy_and_devito_tpu(topology):
    u, ref = sharded_u(dt, topology)
    uj, refj = sharded_u(dj, topology)
    assert np.array_equal(ref, refj)
    assert isinstance(u.data, DataT) and isinstance(uj.data, DataJ)
    assert np.array_equal(np.asarray(u.data), ref)
    for idx in READS:
        got = np.asarray(u.data[idx])
        assert np.array_equal(got, ref[idx]), idx
        assert np.array_equal(got, np.asarray(uj.data[idx])), idx
    assert u.data.shape == ref.shape and len(u.data) == 2
    assert u.data.dtype == np.float32 and u.data.ndim == 3

    # writes: through the view into the device tensor, then read back
    writes = [((0, 1, 1), 1.), ((1, slice(2, -2), slice(2, -2)), 7.),
              ((0, slice(None), 5), 3.),
              ((1, slice(6, 2, -1), 4), np.arange(4, dtype=np.float32)),
              ((0, [1, 5, 9], slice(0, 2)), -2.)]
    for idx, v in writes:
        u.data[idx] = v
        uj.data[idx] = v
        ref[idx] = v
    assert isinstance(u.data, DataT)
    assert np.array_equal(np.asarray(u.data), ref)
    assert np.array_equal(np.asarray(uj.data), ref)


@pytest.mark.parametrize('topology', [(2, 2), (4, 2)])
def test_boolean_masks_and_reductions(topology):
    u, ref = sharded_u(dt, topology, seed=1)
    uj, _ = sharded_u(dj, topology, seed=1)
    mask = ref > 0.5
    assert np.array_equal(u.data[mask], ref[mask])
    assert np.array_equal(u.data[mask], np.asarray(uj.data[mask]))
    rowmask = np.zeros(16, dtype=bool)
    rowmask[[2, 5, 11]] = True
    assert np.array_equal(u.data[0, rowmask, 3], ref[0, rowmask, 3])
    assert np.array_equal(u.data[1, rowmask, 1:7], ref[1, rowmask, 1:7])
    m2 = (np.arange(256).reshape(16, 16) % 3 == 0)
    assert np.array_equal(u.data[1, m2], ref[1, m2])
    assert np.array_equal(u.data[1, ...][m2], ref[1][m2])
    u.data[mask] = 9.
    uj.data[mask] = 9.
    ref[mask] = 9.
    u.data[0, m2] = -1.
    uj.data[0, m2] = -1.
    ref[0, m2] = -1.
    assert np.array_equal(np.asarray(u.data), ref)
    assert np.array_equal(np.asarray(uj.data), ref)
    for name in ('min', 'max', 'sum', 'all', 'any'):
        got = getattr(u.data, name)()
        assert got == getattr(ref, name)() or np.isclose(
            got, getattr(ref, name)(), rtol=1e-6), name
        assert np.isclose(got, getattr(uj.data, name)(), rtol=1e-6), name
    assert np.array_equal(u.data.max(axis=0), ref.max(axis=0))
    with pytest.raises(IndexError):
        u.data[np.zeros((3, 16), dtype=bool), 0]
    with pytest.raises(IndexError):
        u.data[0, 16, 0]


def test_windowed_read_copies_only_its_box(monkeypatch):
    """A read crosses to the host as the bounding box of what it selects
    (devito_tpu: only the window ships), not the whole tensor."""
    u, ref = sharded_u(dt, (2, 2), shape=(32, 32))
    seen = []
    host = DataT._host
    monkeypatch.setattr(DataT, '_host', lambda self, view: (
        seen.append(tuple(view.shape)), host(self, view))[1])
    win = u.data[0:2, 14:18, 14:18]
    assert np.array_equal(win, ref[0:2, 14:18, 14:18])
    assert seen == [(2, 4, 4)]
    assert u.data[0, 16, 16] == ref[0, 16, 16]
    assert seen[-1] == (1, 1, 1)


def test_host_data_before_an_apply_and_on_an_unsharded_grid():
    """``.data`` stays the plain numpy view where the host is authoritative
    and on an unsharded grid."""
    grid = dt.Grid(shape=(8, 8))
    grid._distributor = DistT(grid, topology=(2, 2),
                              devices=[torch.device('cpu')] * 4)
    f = dt.Function(name='f', grid=grid)
    assert isinstance(f.data, np.ndarray)
    g = dt.Function(name='g', grid=dt.Grid(shape=(8, 8)))
    g._device_array()
    g._set_device_array(g._device_array())
    assert isinstance(g.data, np.ndarray)
