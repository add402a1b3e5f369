"""K1's units named after their equations: each generated translation
unit's point struct is ``Point_<target>`` inside the unnamed namespace,
so that a device trace's K1 events say which equation ran, and the
benchmark's readers that split K1's time by unit (``gpubench/units.py``,
``gpubench/metrics/k1_*_ms_per_step.py``), beside ``dense_roofline``."""

import pickle
import re
from types import SimpleNamespace

import numpy as np
import pytest

import devito_tpu_torch as dt
from devito_tpu_torch.ir.lowering import lower_expressions
from devito_tpu_torch.kernels import stencil as K
from devito_tpu_torch.models.seismic import (AcquisitionGeometry,
                                             ElasticWaveSolver, elastic_setup)
from gpubench import units
from gpubench.manifest import Manifest
from gpubench.tracefile import JOB_SPAN, Trace

dt.configuration['device'] = 'cpu'

STRUCT = re.compile(r'namespace \{\nstruct (Point_\w+) \{')


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _struct(plan):
    """The point struct a unit defines, checked to be the one its launch
    template takes."""
    (name,) = STRUCT.findall(plan.source)
    assert 'struct Point {' not in plan.source
    launches = re.findall(r'dtpu::\w+<[^;]*?(Point\w*)>\(', plan.source)
    assert launches and set(launches) == {name}
    return name


def _acoustic_item():
    g = dt.Grid(shape=(16, 17, 18), extent=(15., 16., 17.))
    u = dt.TimeFunction(name='u', grid=g, time_order=2, space_order=8)
    eq = dt.Eq(u.forward, dt.solve(u.dt2 - u.laplace, u.forward))
    (item,) = [i for i in lower_expressions([eq], subs=g.spacing_map)
               .all_items if getattr(i, 'kind', '') == 'dense']
    return item


@pytest.mark.parametrize('design', ['stream', 'point'])
def test_both_designs_name_the_point_struct_after_the_target(design):
    plan = K.plan_for(_acoustic_item(), _design='point' if design == 'point'
                      else None)
    assert plan.design == design
    assert _struct(plan) == 'Point_u'
    # inside the unnamed namespace: internal linkage, as before
    tail = plan.source.split('namespace {\n', 1)[1]
    assert 'struct Point_u {' in tail.split('}  // namespace', 1)[0]


def _elastic(nrec):
    """The elastic forward at a small size with a receiver line of
    ``nrec``: 8 ``nrec`` corners, the dense temporary's rule at 4096."""
    s = elastic_setup(shape=(12, 11, 10), spacing=(10., 10., 10.), tn=20.,
                      nbl=4, space_order=4)
    pos = np.stack([np.linspace(0., 110., nrec), np.full(nrec, 50.),
                    np.full(nrec, 20.)], 1)
    geometry = AcquisitionGeometry(s.model, pos, s.geometry.src_positions,
                                   0., 20., f0=0.010, src_type='Ricker')
    return ElasticWaveSolver(s.model, geometry, space_order=4)


def _names(op):
    return {eq.target.name: _struct(p) for eq, p in op.kernel_plans
            if p is not None}


def test_elastic_units_are_told_apart():
    """The velocities share one fused unit and the stresses another
    (kernels/stencil.py ``plan_run``), each named after its equations'
    targets, which the readers split by (``gpubench/units.py``)."""
    names = _names(_elastic(512).op_fwd(None))
    vel = ['v_x', 'v_y', 'v_z']
    tau = ['tau_xx', 'tau_xy', 'tau_xz', 'tau_yy', 'tau_yz', 'tau_zz']
    for fs in (vel, tau):
        for f in fs:
            assert names[f] == 'Point_' + '__'.join(fs)
    assert len({names[f] for f in vel + tau}) == 2
    fields = vel + tau
    # CIRE's div(v), the three hoisted means of mu (numbered from a
    # counter every lowering in the process advances) and the receivers'
    # dense div(v): one name, their kind
    temps = [n for n in names if n not in fields]
    assert len(temps) == 5 and {'cire0', 'rec2_itmp'} <= set(temps)
    assert {names[n] for n in temps} == {'Point_temporary'}


def test_units_keep_their_keys_across_lowerings():
    """The hoisting pass numbers its temporaries from a counter each
    lowering advances: named by kind, the units keep their keys, as does
    the unpickled Operator (the dense temporary too)."""
    def keys(op):
        return [p.key for _, p in op.kernel_plans if p is not None]
    ops = [_elastic(512).op_fwd(None) for _ in range(2)]
    assert keys(ops[0]) == keys(ops[1])
    again = pickle.loads(pickle.dumps(ops[0]))
    assert keys(again) == keys(ops[0])
    assert _names(again)['rec2_itmp'] == 'Point_temporary'


# -- the readers that split K1 by unit -----------------------------------

def _x(cat, name, ts, end):
    return {'ph': 'X', 'cat': cat, 'name': name, 'pid': 1, 'tid': 1,
            'ts': ts, 'dur': end - ts}


def _k1(point, design='stencil_kernel<float, float, 3, 5, 2'):
    return f'void dtpu::{design}, (anonymous namespace)::{point}>(x)'


#: one traced job of 2 steps, 0-1000 us: K1 units of each kind, a
#: streaming one among them, beside a scatter and a copy
EVENTS = [
    _x('user_annotation', JOB_SPAN, 0, 1000),
    _x('kernel', _k1('Point_temporary', 'stencil_kernel<float, float, 3, '
                     '1, 0'), 10, 30),
    _x('kernel', _k1('Point_v_x'), 40, 140),
    _x('kernel', _k1('Point_v_z'), 150, 250),
    _x('kernel', _k1('Point_temporary', 'stream_kernel<dtpu::StreamTile<'
                     'float, 3, 1, 2, 2, 2, 16, 32, 2, 2, dtpu::Radii<2, 2, '
                     '2>>, 1'), 260, 300),
    _x('kernel', _k1('Point_tau_xx'), 300, 420),
    _x('kernel', _k1('Point_tau_xy'), 420, 500),
    _x('kernel', _k1('Point_temporary'), 500, 530),
    _x('kernel', 'void at::native::index_put_kernel(x)', 530, 560),
    _x('gpu_memcpy', 'Memcpy DtoH', 560, 600),
]

#: by hand, over 2 steps: v 200 us, tau 200, the rest 20 + 40 + 30 = 90
WANT = {'k1_velocity_ms_per_step': 0.1, 'k1_stress_ms_per_step': 0.1,
        'k1_temps_ms_per_step': 0.045}


def _ctx(events, steps=2, bound=None):
    return SimpleNamespace(trace=Trace(events), traced_steps=steps,
                           bound=bound)


@pytest.mark.parametrize('name', sorted(WANT))
def test_unit_readers_on_a_hand_built_trace(name):
    read = Manifest.reader('per_layer', name)
    assert read(_ctx(EVENTS)) == pytest.approx(WANT[name], rel=1e-12)


def test_unit_readers_split_all_of_k1():
    tr = Trace(EVENTS)
    split = sum(Manifest.reader('per_layer', n)(_ctx(EVENTS)) for n in WANT)
    assert split == pytest.approx(1e3 * tr.seconds(('stencil',)) / 2,
                                  rel=1e-12)
    assert units.seconds_by_unit(tr) == pytest.approx(
        {'temporary': 90e-6, 'v_x': 100e-6, 'v_z': 100e-6,
         'tau_xx': 120e-6, 'tau_xy': 80e-6})


@pytest.mark.parametrize('name', sorted(WANT))
def test_unit_readers_find_nothing_without_named_units(name):
    """Without a trace, or on a program whose units are all ``Point``
    (the unnamed structs before the names), no number and no error."""
    read = Manifest.reader('per_layer', name)
    unnamed = [dict(e, name=re.sub(r'Point_\w+', 'Point', e['name']))
               for e in EVENTS]
    assert read(_ctx(unnamed)) is None
    assert read(SimpleNamespace(trace=None, traced_steps=0)) is None
    assert read(_ctx([])) is None


def test_elastic_roofline_on_a_hand_built_trace():
    """The elastic cell's share of its roofline, which dense_roofline
    reads there: the bound over the device ms a step of every event
    outside scatter and gather, 530 us of them over 2 steps."""
    assert 'elastic.shots' in next(
        m for m in Manifest().data['per_layer']
        if m['name'] == 'dense_roofline')['workloads']
    read = Manifest.reader('per_layer', 'dense_roofline')
    tr = Trace(EVENTS)
    secs = tr.seconds(exclude=('scatter', 'gather'))
    assert secs == pytest.approx(530e-6)
    assert read(_ctx(EVENTS, bound=(0.0135, 'bytes'))) == pytest.approx(
        100 * 0.0135 / 0.265)
    assert read(_ctx(EVENTS)) is None
    assert read(SimpleNamespace(trace=None, traced_steps=0,
                                bound=(1.0, 'bytes'))) is None
