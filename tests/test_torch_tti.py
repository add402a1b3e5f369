"""The TTI forward model through devito_tpu_torch against devito_tpu: the
centered kernel in 2-D and 3-D and the staggered kernel in 2-D, on
``tti_setup``'s layered model and on one with seeded smooth tilt fields,
both packages from the same model, source and receiver state carried over
with ``load_numpy_state``. The receivers and both wavefields agree to
rtol 1e-10 in fp64 and 5e-4 in fp32 (max |diff| over max |devito_tpu|:
the two sum the same stencil in another order, so fp32 rounding parts over
the 2-D run's 134 steps; measured 2e-5 on the receivers and 1.3e-4 on v)."""

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu.models.seismic import tti as tj
from devito_tpu_torch.models.seismic import tti as tt
from devito_tpu_torch.utils import load_numpy_state, numpy_state

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

RTOL = {np.float64: 1e-10, np.float32: 5e-4}


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _state_fns(s):
    m = s.model
    return [m.vp, m.damp, m.epsilon, m.delta, m.theta] + \
        ([m.phi] if m.dim == 3 else []) + [s.geometry.src, s.geometry.rec]


def smooth_field(shape, rng, amp):
    """A seeded smooth field: a sum of three plane waves of random
    direction and phase, scaled to [-amp, amp]."""
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in shape],
                        indexing='ij')
    f = np.zeros(shape)
    for _ in range(3):
        k = rng.uniform(0.5, 2.0, len(shape))
        f += np.cos(2 * np.pi * sum(ki * g for ki, g in zip(k, grids))
                    + rng.uniform(0, 2 * np.pi))
    return amp * f / np.abs(f).max()


def solver_pair(shape, so, kernel, dtype, tilt_seed=None, tn=250.,
                spacing=15., nbl=10):
    """(port, devito_tpu) solvers from the same state: devito_tpu's model,
    source and receivers, carried over with ``load_numpy_state``; with
    ``tilt_seed``, devito_tpu's theta (and phi in 3-D) first get seeded
    smooth fields."""
    kw = dict(shape=shape, spacing=[spacing] * len(shape), tn=tn,
              space_order=so, nbl=nbl, dtype=dtype, kernel=kernel)
    sj = tj.tti_setup(**kw)
    if tilt_seed is not None:
        rng = np.random.default_rng(tilt_seed)
        for f, amp in ((sj.model.theta, 0.6), (getattr(sj.model, 'phi',
                                                        None), 0.4)):
            if f is not None:
                f.data[:] = smooth_field(f.shape, rng, amp)
    state = numpy_state(_state_fns(sj))
    st = tt.tti_setup(**kw)
    load_numpy_state(_state_fns(st), state)
    assert st.dt == sj.dt
    return st, sj


def forward_pair(shape, so, kernel, dtype, tilt_seed=None, tn=250.):
    """[(port, devito_tpu)] of rec, u and v after a TTI forward from the
    same state, and the port's forward operator."""
    st, sj = solver_pair(shape, so, kernel, dtype, tilt_seed, tn)
    outs = [[np.array(f.data) for f in s.forward()[:3]] for s in (st, sj)]
    op = st.op_fwd(None)
    return list(zip(*outs)), op


def assert_close(pairs, rtol):
    for got, want in pairs:
        assert got.shape == want.shape and np.abs(want).max() > 0
        assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize('tilt_seed', [None, 7])
@pytest.mark.parametrize('shape,so,kernel', [
    ((30, 35), 4, 'centered'),
    ((30, 35), 8, 'centered'),
    ((24, 26, 28), 4, 'centered'),
    ((30, 35), 4, 'staggered'),
])
def test_forward_matches_devito_tpu(shape, so, kernel, tilt_seed):
    outs, op = forward_pair(shape, so, kernel, np.float64, tilt_seed)
    for got, want in outs:
        assert got.dtype == np.float64 and np.abs(want).max() > 0
        assert np.abs(got - want).max() <= \
            RTOL[np.float64] * np.abs(want).max()
    # every dense equation of the loop, CIRE's temporaries and the
    # hoisted prologue items included, is planned for K1's point design
    plans = op.kernel_plans
    assert plans and all(p is not None and p.design == 'point'
                         for _, p in plans)


def test_forward_fp32_matches_devito_tpu():
    outs, _ = forward_pair((30, 35), 8, 'centered', np.float32, 7)
    for got, want in outs:
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= \
            RTOL[np.float32] * np.abs(want).max()


def test_canonical_2d_drive():
    """The README's drive of the port: a 2-D TTI forward on tti_setup's
    layered model, 30x35 SO=8 fp32, with its receiver norm."""
    s = tt.tti_setup(shape=(30, 35), spacing=(15., 15.), tn=250.,
                     space_order=8, nbl=10)
    rec = s.forward()[0]
    assert abs(np.linalg.norm(rec.data) - 1179.9) < 0.5


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_so12_schedule_streams_its_wide_cire_stars(dtype):
    """The centred TTI forward at SO=12 with hoist-trig-taps True (the
    setting 'auto' picks at the canonical size): cire2 and cire3 run on
    K1's streaming design, each staged group at its own reach; the
    halo-extended items (cire0, cire1, the hoisted trig fields) and the
    updates of u and v, whose groups are read at their centre only, run on
    the point design, each with its reason; cire0 with cire1, and u with
    v, share a fused point unit (kernels/stencil.py ``plan_run``)."""
    from devito_tpu_torch.kernels import stencil as K
    s = tt.tti_setup(shape=(24, 22, 26), spacing=(20.,) * 3, tn=10.,
                     space_order=12, nbl=4, dtype=dtype,
                     opt=('advanced', {'hoist-trig-taps': True}))
    plans = {eq.target.name: (eq, p) for eq, p in s.op_fwd(None).kernel_plans}
    stream = {n for n, (_, p) in plans.items() if p.design == 'stream'}
    assert stream == {'cire2', 'cire3'}
    trig = [n for n, (eq, _) in plans.items()
            if getattr(eq.target, '_hoisted', False)]
    assert len(trig) == 4
    radii = {n: {p.groups[k]['fn'].name: r
                 for k, r in zip(p.staged, p.group_radii)}
             for n, (_, p) in plans.items() if n in stream}
    r0, r1, r2, r3 = sorted(trig, key=lambda n: int(n[1:]))
    assert radii['cire3'] == {'u': (6, 6, 6), 'cire1': (3, 3, 3),
                              r0: (0, 0, 3), r1: (3, 0, 0), r2: (3, 3, 0),
                              r3: (0, 3, 0)}
    assert radii['cire2'] == {'cire0': (3, 3, 3), r0: (0, 0, 3),
                              r1: (3, 0, 0), r2: (3, 3, 0), r3: (0, 3, 0)}
    for n in stream:
        _, p = plans[n]
        assert p.radii == max(radii[n].values())
        assert p.design_reason.startswith("3-D star of ")
    for n, (eq, p) in plans.items():
        if n in stream:
            continue
        assert p.design == 'point'
        alone = K.plan_for(eq)
        assert alone.design == 'point'
        if n in ('u', 'v', 'rec_itmp'):
            assert alone.design_reason == 'no group is read off its centre'
        else:
            assert alone.design_reason.startswith('halo-extended region')
    for pair in (('cire0', 'cire1'), ('u', 'v')):
        unit = plans[pair[0]][1]
        assert [e.target.name for e in unit.eqs] == list(pair)
        assert plans[pair[1]][1] is unit
        assert unit.design_reason.startswith('2 independent equations')
    # the trig fields are read along their own axes only
    assert K.point_flops(plans['cire3'][1]) == 139
