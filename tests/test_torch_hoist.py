"""Invariant hoisting (devito_tpu_torch/ir/optimize.py) against devito_tpu's
pass: ``hoist_invariants`` with ``hoist-trig-taps`` True, False and 'auto'
builds the schedule devito_tpu builds, and the TTI forward through the
port then matches devito_tpu's (fp64, rtol 1e-10: the two run the same
arithmetic in another order, so they agree to rounding, not to the
bit)."""

import numpy as np
import pytest
import sympy
import torch

import devito_tpu as dj
import devito_tpu_torch as dt
from devito_tpu.ir import optimize as oj
from devito_tpu.models.seismic import tti as tj
from devito_tpu_torch.ir import optimize as ot
from devito_tpu_torch.models.seismic import tti as tt
from devito_tpu_torch.utils import load_numpy_state, numpy_state

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _items(op):
    """(section, target, region, operation count) of each dense item; the
    hoisted temporaries' counter names replaced by their order."""
    names, out = {}, []
    for sec in ('prologue', 'body', 'epilogue'):
        for it in getattr(op._schedule, sec):
            if not hasattr(it, 'region'):
                out.append((sec, it.kind, it.sparse.name))
                continue
            name = it.target.name
            if name[0] == 'r' and name[1:].isdigit():
                name = names.setdefault(name, f'r#{len(names)}')
            out.append((sec, name, tuple(it.region),
                        sympy.count_ops(it.rhs),
                        getattr(it, 'internal', False)))
    return out


def _model_fns(s):
    m = s.model
    return [m.vp, m.damp, m.epsilon, m.delta, m.theta] + \
        ([m.phi] if m.dim == 3 else [])


def _forward_pair(shape, so, trig):
    """(port's op, devito_tpu's op, [(port, devito_tpu) rec, u, v]) of the
    TTI centered forward under ``hoist-trig-taps`` = ``trig``, from
    devito_tpu's model, source and receiver state."""
    opt = ('advanced', {'hoist-trig-taps': trig})
    sj = tj.tti_setup(shape=shape, spacing=[15.] * len(shape), tn=200.,
                      space_order=so, nbl=10, dtype=np.float64, opt=opt)
    st = tt.tti_setup(shape=shape, spacing=[15.] * len(shape), tn=200.,
                      space_order=so, nbl=10, dtype=np.float64, opt=opt)
    geo = [sj.geometry.src, sj.geometry.rec]
    state = numpy_state(_model_fns(sj) + geo)
    load_numpy_state(_model_fns(st) + [st.geometry.src, st.geometry.rec],
                     state)
    outs = [[np.array(f.data) for f in s.forward()[:3]] for s in (st, sj)]
    return st.op_fwd(None), sj.op_fwd(None), list(zip(*outs))


@pytest.mark.parametrize('trig', [True, False, 'auto'])
@pytest.mark.parametrize('shape,so', [((30, 35), 8), ((20, 22, 24), 4)])
def test_hoisting_matches_devito_tpu(shape, so, trig):
    opt_t, opt_j, outs = _forward_pair(shape, so, trig)
    assert _items(opt_t) == _items(opt_j)
    hoisted = [it for it in opt_t._schedule.prologue if it.internal]
    # in 2-D the stream accounting turns down all but the trig taps
    assert bool(hoisted) == (len(shape) == 3 or trig is True)
    assert all(not it.time_dep for it in hoisted)
    # each hoisted item covers CIRE's halo-extended regions
    ext = max(-a for it in opt_t._schedule.body if hasattr(it, 'region')
              for a, _ in it.region)
    assert ext > 0 and all(it.region[0][0] <= -ext for it in hoisted)
    for got, want in outs:
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_trig_taps_rewrites_shifted_transcendentals():
    """True hoists each transcendental of a tilt field once, over its
    consumers' reach, and the time loop then reads it at shifted taps: no
    sin or cos of a model field is left in the loop. False and 'auto' (at
    this size) leave them there."""
    def trig_in_body(trig):
        s = tt.tti_setup(shape=(16, 18, 20), spacing=(15.,) * 3, tn=40.,
                         space_order=4, nbl=4,
                         opt=('advanced', {'hoist-trig-taps': trig}))
        body = [it for it in s.op_fwd(None)._schedule.body
                if hasattr(it, 'region')]
        return sum(len(sympy.sympify(it.rhs).atoms(sympy.sin, sympy.cos))
                   for it in body)
    assert trig_in_body(True) == 0
    assert trig_in_body(False) == trig_in_body('auto') > 0


@pytest.mark.parametrize('shape', [(16, 18, 20), (40, 30)])
def test_auto_rule_measures_as_devito_tpu(shape):
    """The 'auto' rule's byte count of the body's shifted transcendentals
    is devito_tpu's, and stays below 1.5e9 at these sizes."""
    got = []
    for mod, opt in ((tt, ot), (tj, oj)):
        s = mod.tti_setup(shape=shape, spacing=[15.] * len(shape), tn=40.,
                          space_order=8, nbl=4, opt='noop')
        body = [it for it in s.op_fwd(None)._schedule.body
                if hasattr(it, 'region')]
        written = {it.target.name for it in body}
        got.append(opt._shifted_trig_blowup_bytes(body, written))
    assert got[0] == got[1] and 0 < got[0] < 1.5e9


def test_no_hoisting_under_noop_or_when_turned_off():
    for opt in ('noop', ('advanced', {'hoist-invariants': False})):
        s = tt.tti_setup(shape=(20, 22), spacing=(15., 15.), tn=40.,
                         space_order=4, nbl=4, opt=opt)
        assert not any(getattr(it, 'internal', False)
                       for it in s.op_fwd(None)._schedule.prologue)


def test_hoist_invariants_on_a_plain_equation():
    """A division and a transcendental of a time-invariant field, read by a
    time-stepping update: hoisted into one prologue temporary in both
    packages, and the update reads it."""
    scheds = []
    for pkg, opt in ((dt, ot), (dj, oj)):
        g = pkg.Grid(shape=(12, 14), extent=(11., 13.))
        u = pkg.TimeFunction(name='u', grid=g, space_order=2)
        f = pkg.Function(name='f', grid=g, space_order=2)
        eq = pkg.Eq(u.forward, u + pkg.sin(f) / (1 + f * f) * u.laplace)
        op = pkg.Operator(eq, opt='noop')
        scheds.append(opt.hoist_invariants(op._schedule, trig_taps=False))
    (pt, pj) = scheds
    assert len(pt.prologue) == len(pj.prologue) == 1
    assert pt.prologue[0].internal and pt.prologue[0].region == \
        pj.prologue[0].region
    from devito_tpu_torch.types.basic import retrieve_functions
    assert pt.prologue[0].target.name in {
        a.function.name for a in retrieve_functions(pt.body[0].rhs)}


def test_units_keep_their_keys_across_lowerings_and_pickling():
    """The hoisting pass numbers its temporaries from a counter every
    lowering advances; a unit names a temporary by its kind, so the same
    equations lowered again, or the Operator unpickled, keep their K1
    unit keys (no new nvcc build)."""
    import pickle

    def keys(op):
        return [p.key for _, p in op.kernel_plans if p is not None]
    def darcy():
        # examples/cfd.py darcy_flow's update: a.grad's average is hoisted
        grid = dt.Grid(shape=(8, 8), extent=(1., 1.))
        u = dt.TimeFunction(name='u', grid=grid, space_order=2)
        a = dt.Function(name='a', grid=grid, space_order=2)
        f1 = dt.Function(name='f1', grid=grid)
        eq = dt.Eq(-dt.div(a * dt.grad(u, shift=.5), shift=-.5), f1)
        return dt.Operator(dt.Eq(u.forward, dt.solve(eq, u)))
    ops = [darcy(), darcy()]
    names = [[eq.target.name for eq, _ in op.kernel_plans] for op in ops]
    assert keys(ops[0]) == keys(ops[1])
    assert names[0] != names[1]          # r<n>: the counter moved on
    assert any(getattr(eq.target, '_hoisted', False)
               for eq, _ in ops[0].kernel_plans)
    assert keys(pickle.loads(pickle.dumps(ops[0]))) == keys(ops[0])
