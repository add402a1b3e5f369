"""Host streaming of save=nt wavefields through devito_tpu_torch, against
devito_tpu (tests/test_streaming.py's setup: 36x36 OT2 SO=4 fp64, nbl 6,
tn 120).

- The streaming plan (the streamed functions, K, span_lo, rows) equals
  devito_tpu's for the forward and gradient operators at four budgets and
  modes, one where 'auto' declines, and both decline a prologue increment.
- The streamed forward is bit-equal to the port's resident one and within
  1e-10 x max of devito_tpu's resident forward; the streamed gradient
  equals the resident one at devito_tpu's rtol 1e-12 / atol 1e-13
  (tests/test_streaming.py:65) and devito_tpu's streamed gradient within
  1e-10 x max.
- ``estimate_memory`` equals devito_tpu's, layered and not.
- A 3-D case whose K does not divide the steps, a bf16 save, errctl
  raising at the chunk that fails, and a pickled operator.
"""

import logging
import pickle

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu.models import seismic as sj  # noqa: E402
from devito_tpu_torch.logger import logger  # noqa: E402
from devito_tpu_torch.models import seismic as st  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

#: Port against devito_tpu over a whole run, fp64 (tests/test_torch_inverse.py)
RUN_TOL = 1e-10


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _setup(seis, shape=(36, 36), so=4, nbl=6, tn=120.):
    return seis.acoustic_setup(shape=shape, spacing=[12.5] * len(shape),
                               kernel='OT2', nbl=nbl, tn=tn, space_order=so,
                               preset='layers-isotropic', dtype=np.float64)


def _close(got, want, tol=RUN_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(want).max() > 0
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _both(**cfg):
    """switchconfig of both packages."""
    class Both:
        def __enter__(self):
            self.a = dj.switchconfig(**cfg)
            self.b = dt.switchconfig(**cfg)
            self.a.__enter__()
            self.b.__enter__()

        def __exit__(self, *args):
            self.b.__exit__(*args)
            self.a.__exit__(*args)
    return Both()


def _plan(op):
    p = op._plan_streaming(dict(op._reads))
    return None if p is None else (sorted(p['fns']), p['K'], p['span_lo'],
                                   p['rows'])


def _run(seis, mode='off', budget=4 << 30, shape=(36, 36), so=4, tn=120.,
         grad=True):
    """(solver, rec, u, grad or None) of a full-save forward and gradient
    under ``save-streaming`` ``mode`` and ``budget``."""
    s = _setup(seis, shape, so, tn=tn)
    cfg = seis is sj and dj.switchconfig or dt.switchconfig
    with cfg(**{'save-streaming': mode, 'save-budget': budget}):
        rec, u, _ = s.forward(save=True)
        if mode == 'on':
            assert s.op_fwd(True)._stream_plan is not None
        out = [s, np.array(rec.data), np.array(u.data), None]
        if grad:
            g, _ = s.jacobian_adjoint(rec, u, src=s.geometry.src)
            if mode == 'on':
                assert s.op_grad()._stream_plan is not None
            out[3] = np.array(g.data)
    return out


@pytest.fixture(scope='module')
def ops():
    """The forward and gradient operators of both packages."""
    J, T = _setup(sj), _setup(st)
    return {'fwd': (J.op_fwd(True), T.op_fwd(True)),
            'grad': (J.op_grad(), T.op_grad())}


@pytest.mark.parametrize('which', ['fwd', 'grad'])
@pytest.mark.parametrize('mode,budget', [('on', 300_000), ('on', 400_000),
                                         ('auto', 400_000),
                                         ('auto', 4 << 30)])
def test_plan_matches_devito_tpu(ops, which, mode, budget):
    opj, opt = ops[which]
    with _both(**{'save-streaming': mode, 'save-budget': budget}):
        pj, pt = _plan(opj), _plan(opt)
    assert pt == pj
    assert (pt is None) == (mode == 'auto' and budget == 4 << 30)
    assert opt._save_spans == opj._save_spans


def _prologue_inc(pkg):
    g = pkg.Grid(shape=(8, 8))
    f = pkg.Function(name='f', grid=g)
    u = pkg.TimeFunction(name='u', grid=g, save=10)
    return pkg.Operator([pkg.Inc(f, 1.), pkg.Eq(u.forward, u + f)])


def test_prologue_increment_declines_in_both(caplog):
    opj, opt = _prologue_inc(dj), _prologue_inc(dt)
    assert len(opt.schedule.prologue) == 1 and opt.schedule.prologue[0] \
        .increment
    with _both(**{'save-streaming': 'on', 'save-budget': 1000}):
        with caplog.at_level(logging.DEBUG, logger=logger.name):
            assert _plan(opj) is None and _plan(opt) is None
    assert any("declined" in r.getMessage() and "accumulates" in
               r.getMessage() for r in caplog.records)


def test_streamed_forward_bit_equal_and_matches_devito_tpu():
    _, r0, u0, _ = _run(st, grad=False)
    s, r1, u1, _ = _run(st, 'on', u0.nbytes // 6, grad=False)
    op = s.op_fwd(True)
    assert op._stream_plan['K'] < u0.shape[0] - 2 and \
        len(op._stream_log) > 2
    assert np.array_equal(r1, r0) and np.array_equal(u1, u0)
    _, rj, uj, _ = _run(sj, grad=False)
    _close(r1, rj)
    _close(u1, uj)


def test_streamed_gradient_matches_resident_and_devito_tpu():
    *_, g0 = _run(st)
    *_, g1 = _run(st, 'on', 400_000)
    assert np.allclose(g1, g0, rtol=1e-12, atol=1e-13)
    *_, gj = _run(sj, 'on', 400_000)
    _close(g1, gj)


@pytest.mark.parametrize('mode,budget', [('on', 300_000), ('auto', 4 << 30),
                                         ('off', 300_000)])
def test_estimate_memory_matches_devito_tpu(ops, mode, budget):
    for opj, opt in ops.values():
        with _both(**{'save-streaming': mode, 'save-budget': budget}):
            assert opt.estimate_memory(layers=True) == \
                opj.estimate_memory(layers=True)
            assert opt.estimate_memory() == opj.estimate_memory()
    if mode == 'on':
        opt = ops['fwd'][1]
        with dt.switchconfig(**{'save-streaming': mode,
                                'save-budget': budget}):
            lay = opt.estimate_memory(layers=True)
        full = opt.estimate_memory()
        assert 0 < lay['device'] < full < lay['device'] + lay['host']


def test_3d_chunks_not_dividing_the_steps():
    """20x22x24 SO=8: a window of K + 2 rows of 552 x 560 x 640 B; K
    does not divide the steps, so the last chunk is short."""
    kw = dict(shape=(20, 22, 24), so=8, tn=60.)
    _, r0, u0, g0 = _run(st, **kw)
    s = _setup(st, (20, 22, 24), 8, tn=60.)
    row = int(np.prod(s.op_fwd(True)._reads['u'].shape_allocated[1:])) * 8
    budget = 9 * row                    # K = 7 (forward), 9 (gradient)
    s, r1, u1, g1 = _run(st, 'on', budget, **kw)
    for op, K in ((s.op_fwd(True), 7), (s.op_grad(), 9)):
        plan, log = op._stream_plan, op._stream_log
        steps = sum(c1 - c0 + 1 for (c0, c1) in (r['steps'] for r in log))
        assert plan['K'] == K and steps % K and \
            len(log) == -(-steps // K)
    assert s.op_grad()._stream_log[0]['steps'][1] == s.geometry.nt - 2
    assert np.array_equal(r1, r0) and np.array_equal(u1, u0)
    assert np.allclose(g1, g0, rtol=1e-12, atol=1e-13)


def _bf16_op():
    g = dt.Grid(shape=(24, 24), extent=(230., 230.))
    u = dt.TimeFunction(name='u', grid=g, space_order=4, save=30)
    u.data[0, 10:14, 10:14] = 1.
    eq = dt.Eq(u.forward, dt.solve(u.dt - 0.5 * u.laplace, u.forward))
    return dt.Operator(eq, subs=g.spacing_map,
                       opt=('advanced', {'storage-dtype': 'bfloat16'})), u


def test_bf16_save_streamed_bit_equal():
    res = []
    for mode in ('off', 'on'):
        op, u = _bf16_op()
        with dt.switchconfig(**{'save-streaming': mode,
                                'save-budget': 8 * 32 * 128 * 4}):
            op.apply(time_M=27, dt=0.5)
            if mode == 'on':
                assert op._stream_plan['K'] == 7
                assert type(u)._coh == 'host' and type(u)._dev_buf is None
            else:
                assert u._device_array().dtype == torch.bfloat16
        res.append(np.array(u.data))
        dt.clear_cache()
    assert np.array_equal(res[0], res[1]) and np.abs(res[0]).max() > 0


def test_errctl_raises_at_the_failing_chunk():
    g = dt.Grid(shape=(8, 8))
    v = dt.TimeFunction(name='v', grid=g)
    u = dt.TimeFunction(name='u', grid=g, save=130)
    v.data[0] = 1.
    op = dt.Operator([dt.Eq(v.forward, 1e10 * v), dt.Eq(u.forward, v)],
                     opt=('advanced', {'errctl': 'max'}))
    with dt.switchconfig(**{'save-streaming': 'on', 'save-budget': 1}):
        with pytest.raises(dt.ExecutionError, match='at step 100'):
            op.apply(time_M=125)
        # K = 4: the chunk of steps 100-103 is the 26th and the last run
        assert op._stream_plan['K'] == 4
        assert op._stream_log[-1]['steps'] == (100, 103)
        assert len(op._stream_log) == 26
    assert not np.isfinite(u.data[5]).all()     # absorbed before the raise


def test_pickled_operator_carries_no_plan_and_reruns_equal():
    s = _setup(st)
    u = dt.TimeFunction(name='u', grid=s.model.grid, time_order=2,
                        space_order=4, save=s.geometry.nt)
    with dt.switchconfig(**{'save-streaming': 'on', 'save-budget': 400_000}):
        op = s.op_fwd(True)
        op.apply(src=s.geometry.src, rec=s.geometry.rec, u=u, dt=s.dt)
        assert op._stream_plan is not None
        state = op.__getstate__()
        assert '_stream_plan' not in state and '_stream_log' not in state
        op2 = pickle.loads(pickle.dumps(op))
        op.apply(src=s.geometry.src, rec=s.geometry.rec, u=u, dt=s.dt)
        u2 = op2._reads['u']
        op2.apply(dt=s.dt)
        assert op2._stream_plan is not None
    assert np.array_equal(np.array(u2.data), np.array(u.data))


def test_configuration_keys():
    for k, v in (('save-streaming', 'auto'), ('save-budget', 4 << 30),
                 ('profiling', 'basic'), ('profile-dir', None)):
        assert dt.configuration[k] == dj.configuration[k] == v
    with pytest.raises(dt.InvalidArgument):
        dt.configuration['save-streaming'] = 'always'


def _sharded_setup(topology):
    from devito_tpu_torch.parallel.distributor import Distributor
    s = _setup(st)
    n = int(np.prod(topology))
    s.model.grid._distributor = Distributor(
        s.model.grid, topology=topology, devices=[torch.device('cpu')] * n)
    return s


@pytest.mark.parametrize('topology', [(2, 2), (4, 1)])
def test_streamed_sharded_matches_resident(topology):
    """Streaming through the sharded runner (tests/test_streaming.py's
    sharded cases): each chunk's window is cut into the shards and written
    back from them; the streamed sharded forward is bit-equal to the
    port's resident unsharded one, and within 1e-10 x max of devito_tpu's
    resident forward."""
    _, rec0, u0, _ = _run(st, grad=False)
    s = _sharded_setup(topology)
    with dt.switchconfig(halo='explicit', **{'save-streaming': 'on',
                                             'save-budget': u0.nbytes // 6}):
        op = s.op_fwd(True)
        rec1, u1, _ = s.forward(save=True)
        assert op._stream_plan is not None and op._halo_runner is not None
        assert len(op._stream_log) > 1
    assert np.array_equal(np.array(u1.data), u0)
    _close(np.array(rec1.data), rec0, 1e-13)
    _, recj, uj, _ = _run(sj, grad=False)
    _close(np.array(u1.data), uj)
    _close(np.array(rec1.data), recj)


def test_streamed_sharded_gradient():
    """The gradient reading a host-streamed save wavefield on the sharded
    path equals the resident unsharded gradient (fp64, 1e-12 x max)."""
    *_, g0 = _run(st)
    s = _sharded_setup((2, 2))
    with dt.switchconfig(halo='explicit', **{'save-streaming': 'on',
                                             'save-budget': 400_000}):
        rec, u, _ = s.forward(save=True)
        g, _ = s.jacobian_adjoint(rec, u, src=s.geometry.src)
        assert s.op_grad()._stream_plan is not None
        assert s.op_grad()._halo_runner is not None
    _close(np.array(g.data), g0, 1e-12)
