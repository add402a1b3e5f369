"""The ``opt`` argument of devito_tpu_torch's Operator: the run options
(narrow storage, its scope, the errctl scan) build operators that write
what devito_tpu's write under the same options, unknown keys and values
raise InvalidArgument, and the lowering options steer CIRE and the
hoisting pass as devito_tpu's do."""

import numpy as np
import pytest
import torch

import devito_tpu as dj
import devito_tpu_torch as dt
from devito_tpu_torch import InvalidArgument

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _bench_eq(n=10, pkg=dt):
    """bench.py's damped acoustic update at n^3 SO=4, seeded, in ``pkg``."""
    grid = pkg.Grid(shape=(n,) * 3, extent=(10. * (n - 1),) * 3)
    u = pkg.TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    vp = pkg.Function(name='vp', grid=grid, space_order=4)
    damp = pkg.Function(name='damp', grid=grid, space_order=4)
    rng = np.random.default_rng(5)
    vp.data[:] = 1.5 + rng.random(vp.shape)
    u.data[:2] = rng.standard_normal((2,) + grid.shape)
    pde = (1 / (vp * vp)) * u.dt2 - u.laplace + damp * u.dt
    return grid, u, pkg.Eq(u.forward, pkg.solve(pde, u.forward))


@pytest.mark.parametrize('options', [
    {'storage-dtype': 'bfloat16'},            # bench.py's second row
    {'storage-dtype': 'float16', 'storage-dtype-scope': 'all'},
    {'storage-dtype-scope': 'fields'},
    {'errctl': 'max'},
    {'cire': False, 'errctl': 'max'},
])
def test_run_options_build_and_match_devito_tpu(options):
    """Each run option builds, and 3 steps of bench.py's update under it
    write what devito_tpu's write under it: within one ulp of the storage
    dtype at max |devito_tpu| (bf16 2^-7, fp16 2^-10; fp32 rows 1e-5, as
    the packages' fp32 sums run in other orders)."""
    out = []
    for pkg in (dj, dt):
        grid, u, eq = _bench_eq(pkg=pkg)
        op = pkg.Operator(eq, subs=grid.spacing_map,
                          opt=('advanced', options))
        op.apply(time_m=1, time_M=3, dt=1.2)
        out.append(np.array(u.data, dtype=np.float64))
    eps = {'bfloat16': 2. ** -7, 'float16': 2. ** -10}.get(
        options.get('storage-dtype'), 1e-5)
    want, got = out
    assert np.abs(got - want).max() <= eps * np.abs(want).max()


@pytest.mark.parametrize('options', [
    {'no-such-option': True},
    {'storage-dtype': 'int3'},
    {'storage-dtype-scope': 'some'},
    {'errctl': 'basic'},
])
def test_options_the_port_does_not_honour_raise(options):
    grid, _, eq = _bench_eq()
    with pytest.raises(InvalidArgument):
        dt.Operator(eq, subs=grid.spacing_map, opt=('advanced', options))


@pytest.mark.parametrize('opt', ['aggressive', ('noop', 'cire'), 3])
def test_bad_modes_and_option_containers_raise(opt):
    grid, _, eq = _bench_eq()
    with pytest.raises(InvalidArgument):
        dt.Operator(eq, subs=grid.spacing_map, opt=opt)


def _tti_items(pkg_tti, opt):
    """Normalised schedule items of a small 3-D TTI forward built with
    ``opt`` (tests/test_torch_cire.py ``schedule_items``)."""
    from test_torch_cire import schedule_items
    s = pkg_tti.tti_setup(shape=(14, 15, 16), spacing=(15.,) * 3, tn=30.,
                          space_order=4, nbl=4, opt=opt)
    return schedule_items(s.op_fwd(None))


@pytest.mark.parametrize('options', [{'cire': False},
                                     {'hoist-invariants': False},
                                     {'hoist-trig-taps': True},
                                     {}])
def test_lowering_options_build_the_noop_schedule(options):
    """'advanced' runs CIRE and the hoisting pass. Each lowering option
    changes a TTI schedule as it changes devito_tpu's: the port's schedule
    under the option equals devito_tpu's, and differs from the default's
    and from 'noop''s exactly where devito_tpu's does. The acoustic update
    has nothing to extract or hoist, so under the option it still builds
    the 'noop' schedule, and runs to the bit as 'noop' does."""
    from devito_tpu.models.seismic import tti as tj
    from devito_tpu_torch.models.seismic import tti as tt
    opt = ('advanced', options)
    got = {k: _tti_items(tt, o) for k, o in
           (('opt', opt), ('default', None), ('noop', 'noop'))}
    want = {k: _tti_items(tj, o) for k, o in
            (('opt', opt), ('default', None), ('noop', 'noop'))}
    assert got == want
    assert (got['opt'] == got['default']) == (options == {})
    assert got['opt'] != got['noop']

    grid, u, eq = _bench_eq()
    op = dt.Operator(eq, subs=grid.spacing_map, opt=opt)
    noop = dt.Operator(eq, subs=grid.spacing_map, opt='noop')
    assert str(op) == str(noop)
    start = u.data_with_halo.copy()
    noop.apply(time_M=3, dt=1.2)
    want = u.data_with_halo.copy()
    u.data_with_halo[:] = start
    op.apply(time_M=3, dt=1.2)
    assert np.array_equal(u.data_with_halo, want)
