"""The executor's one time loop (``compiler/executor.py`` ``_time_loop``),
which the unsharded runner and the sharded one both run: the same span
names in the same order each step, the prologue and the epilogue once
each, outside the steps, and under errctl='max' the halt at the first
check after a blow-up."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import profile, ProfilerActivity

import devito_tpu_torch as dt
from devito_tpu_torch.parallel.distributor import Distributor

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

RUNNERS = ['unsharded', 'sharded (2, 2, 1)']


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _grid(runner):
    grid = dt.Grid(shape=(12, 12, 12), extent=(11., 11., 11.))
    if runner != 'unsharded':
        grid._distributor = Distributor(grid, topology=(2, 2, 1),
                                        devices=[torch.device('cpu')] * 4)
    return grid


def _operator(runner, nt=6, opt=None):
    """u.forward from u, a source injected and a receiver set interpolated
    a step; ``g`` raised by one before the steps and ``h`` after them."""
    grid = _grid(runner)
    u = dt.TimeFunction(name='u', grid=grid, space_order=2)
    g = dt.Function(name='g', grid=grid, space_order=0)
    h = dt.Function(name='h', grid=grid, space_order=0)
    src = dt.SparseTimeFunction(name='src', grid=grid, npoint=1, nt=nt,
                                coordinates=[[5., 5., 5.]])
    src.data[:] = 1.0
    rec = dt.SparseTimeFunction(name='rec', grid=grid, npoint=2, nt=nt,
                                coordinates=[[5., 5., 5.], [2., 8., 3.]])
    op = dt.Operator([dt.Eq(g, g + 1),
                      dt.Eq(u.forward, 0.5 * u + 0.1 * u.dx),
                      src.inject(field=u.forward, expr=src),
                      rec.interpolate(expr=u),
                      dt.Eq(h, h + 1)], opt=opt)
    return op, g, h


def _sections(tmp_path, fn):
    """The names of the executor's section ranges of ``fn()``, in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())['traceEvents']
    return [e['name'] for e in sorted(
        (e for e in evs if e.get('cat') == 'user_annotation' and
         e['name'].startswith('dtpu_')), key=lambda e: float(e['ts']))]


@pytest.mark.parametrize('runner', RUNNERS)
def test_each_step_opens_the_same_sections_in_order(runner, tmp_path):
    op, _, _ = _operator(runner)
    op.apply(time_M=4, dt=1.0)
    assert (op._halo_runner is not None) == (runner != 'unsharded')
    names = _sections(tmp_path, lambda: op.apply(time_M=4, dt=1.0))
    steps = 5
    assert names and len(names) % steps == 0
    one = names[:len(names) // steps]
    assert names == one * steps
    assert len(set(one)) == len(one) or 'dtpu_exchange' in one


@pytest.mark.parametrize('runner', RUNNERS)
def test_prologue_and_epilogue_run_once(runner):
    op, g, h = _operator(runner)
    sched = op.schedule
    assert sched.prologue and sched.epilogue
    op.apply(time_M=4, dt=1.0)
    assert (op._halo_runner is not None) == (runner != 'unsharded')
    assert np.all(np.array(g.data) == 1) and np.all(np.array(h.data) == 1)


@pytest.mark.parametrize('runner', RUNNERS)
def test_errctl_halts_at_the_first_check_after_the_blow_up(runner):
    """u/f is inf from the first step on; run from t = 1 the first check
    is at t = 100, where both runners stop."""
    grid = _grid(runner)
    f = dt.Function(name='f', grid=grid, space_order=2)
    u = dt.TimeFunction(name='u', grid=grid, space_order=2)
    op = dt.Operator(dt.Eq(u.forward, u / f),
                     opt=('advanced', {'errctl': 'max'}))
    u.data[:] = 1.
    with pytest.raises(dt.ExecutionError, match="at step 100"):
        op.apply(time_m=1, time_M=250, dt=.1)
    assert (op._halo_runner is not None) == (runner != 'unsharded')
