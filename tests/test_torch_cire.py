"""CIRE (devito_tpu_torch/ir/cire.py) against devito_tpu's pass: the
patterns of tests/test_cire.py through the port, and the port's schedules
under the default ``opt`` against devito_tpu's for the TTI kernels: the
same items, targets, regions and order in the prologue, the time loop and
the epilogue."""

import numpy as np
import pytest
import sympy
import torch

import devito_tpu as dj
import devito_tpu_torch as dt
from devito_tpu.models.seismic import tti as tj
from devito_tpu_torch.models.seismic import tti as tt

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def schedule_items(op):
    """(section, kind, target, region, time offset, increment, operation
    count of the right-hand side) of every dense item of an operator's
    schedule, and (section, kind, sparse function, field, time offsets) of
    every sparse one, in order. The hoisting pass names its temporaries
    from a process-wide counter (``r<k>``), so those names are replaced by
    their order of first appearance."""
    names = {}
    out = []
    for sec in ('prologue', 'body', 'epilogue'):
        for it in getattr(op._schedule, sec):
            if hasattr(it, 'region'):
                name = it.target.name
                if name[0] == 'r' and name[1:].isdigit():
                    name = names.setdefault(name, f'r#{len(names)}')
                out.append((sec, 'dense', name, tuple(it.region),
                            it.time_off, it.increment,
                            sympy.count_ops(it.rhs)))
            else:
                out.append((sec, it.kind, it.sparse.name,
                            getattr(it.field, 'name', None),
                            it.field_time_off, it.target_time_off))
    return out


def _nested_op(pkg, names, cire):
    rng = np.random.default_rng(0)
    with pkg.switchconfig(cire=cire):
        g = pkg.Grid(shape=(20, 20), extent=(19., 19.), dtype=np.float64)
        x, y = g.dimensions
        u = pkg.TimeFunction(name=names[0], grid=g, space_order=4)
        w = pkg.TimeFunction(name=names[1], grid=g, space_order=4)
        u.data[0] = rng.standard_normal((20, 20))
        inner = pkg.Derivative(u, x, fd_order=2,
                               x0={x: x + sympy.Rational(1, 2) * x.spacing})
        outer = pkg.Derivative(inner, x, fd_order=2,
                               x0={x: x - sympy.Rational(1, 2) * x.spacing})
        op = pkg.Operator([pkg.Eq(w.forward, outer), pkg.Eq(u.forward, u)])
        op.apply(time_M=3, dt=1.)
        return np.array(w.data), op


def test_nested_extraction_exact():
    """A nested Gzz-style derivative: the port's result with CIRE equals
    its result without, and devito_tpu's with CIRE; the temporary is
    extracted and written over a halo-extended region, as devito_tpu's."""
    a, _ = _nested_op(dt, ('ua', 'wa'), cire=False)
    b, op = _nested_op(dt, ('ub', 'wb'), cire=True)
    c, opj = _nested_op(dj, ('ub', 'wb'), cire=True)
    assert np.array_equal(a, b) or np.abs(a - b).max() < 1e-13
    assert np.abs(b - c).max() <= 1e-10 * np.abs(c).max()
    temps = [it for it in op._schedule.body
             if it.target.name.startswith('cire')]
    assert temps and any(r[0] < 0 for r in temps[0].region)
    assert schedule_items(op) == schedule_items(opj)


def test_tti_centered_equal_with_and_without_cire():
    """The whole TTI centered solver through the port: the same receivers
    with and without CIRE (tests/test_cire.py's contract), rtol 1e-10."""

    def run(cire):
        with dt.switchconfig(cire=cire):
            s = tt.tti_setup(shape=(40, 40), spacing=(20., 20.), tn=250.,
                             space_order=4, nbl=10, dtype=np.float64)
            op = s.op_fwd(None)
            ncire = sum(it.target.name.startswith('cire')
                        for it in op._schedule.body if hasattr(it, 'region'))
            return np.array(s.forward()[0].data), ncire

    (a, n0), (b, n1) = run(False), run(True)
    assert n0 == 0 and n1 > 0
    assert np.allclose(a, b, rtol=1e-10, atol=1e-12)


def test_acoustic_untouched():
    """No nested or shared derivatives: the pass changes nothing."""
    g = dt.Grid(shape=(16, 16), extent=(15., 15.))
    u = dt.TimeFunction(name='u', grid=g, time_order=2, space_order=4)
    eq = dt.Eq(u.forward, dt.solve(u.dt2 - u.laplace, u.forward))
    op = dt.Operator(eq, subs=g.spacing_map)
    noop = dt.Operator(eq, subs=g.spacing_map, opt='noop')
    assert not any(it.target.name.startswith('cire')
                   for it in op._schedule.body)
    assert schedule_items(op) == schedule_items(noop)


def test_cire_configuration_and_option():
    """``configuration['cire']`` and ``opt=('advanced', {'cire': False})``
    each turn the pass off, as in devito_tpu."""
    def ncire(**kwargs):
        s = tt.tti_setup(shape=(20, 22), spacing=(15., 15.), tn=50.,
                         space_order=4, nbl=4, **kwargs)
        return sum(it.target.name.startswith('cire')
                   for it in s.op_fwd(None)._schedule.body
                   if hasattr(it, 'region'))
    assert ncire() == 4
    assert ncire(opt=('advanced', {'cire': False})) == 0
    assert ncire(opt='noop') == 0
    with dt.switchconfig(cire=False):
        assert ncire() == 0


@pytest.mark.parametrize('shape,so,kernel', [
    ((30, 35), 4, 'centered'),
    ((30, 35), 8, 'centered'),
    ((24, 26, 28), 4, 'centered'),
    ((30, 35), 4, 'staggered'),
])
def test_tti_schedule_matches_devito_tpu(shape, so, kernel):
    """Under the default ``opt`` the port's forward and adjoint schedules
    equal devito_tpu's: the hoisted prologue items, CIRE's temporaries
    (interleaved before their first consumer, over the same halo-extended
    regions), the updates and the sparse operations, in the same order."""
    ops = []
    for mod in (tj, tt):
        s = mod.tti_setup(shape=shape, spacing=[15.] * len(shape), tn=60.,
                          space_order=so, nbl=10, kernel=kernel)
        ops.append((s.op_fwd(None), s.op_adj()))
    for oj, ot in zip(*ops):
        assert schedule_items(ot) == schedule_items(oj)
    # both kernels share derivative groups between their updates
    assert any(it[2].startswith('cire') for it in schedule_items(ops[1][0]))


@pytest.mark.parametrize('shape,so', [
    ((30, 35), 4),
    ((24, 26, 28), 4),
])
def test_tti_jacobian_schedule_matches_devito_tpu(shape, so):
    """The Jacobian pair, the Born operator and the gradient (with its
    saved forward), under the default ``opt``: the port's schedules equal
    devito_tpu's, CIRE's temporaries and the hoisted items included."""
    ops = []
    for mod in (tj, tt):
        s = mod.tti_setup(shape=shape, spacing=[15.] * len(shape), tn=60.,
                          space_order=so, nbl=10)
        ops.append((s.op_jac(), s.op_jacadj(True)))
    for oj, ot in zip(*ops):
        assert schedule_items(ot) == schedule_items(oj)
    assert all(any(it[2].startswith('cire') for it in schedule_items(o))
               for o in ops[1])
