"""The errctl stability scan (opt ``{'errctl': 'max'}``) through
devito_tpu_torch.

The three cases of tests/test_error_checking.py, each in both packages:
``u/f`` and ``(u + v)/f`` with f = 0 raise ExecutionError, a decaying run
does not and ends as devito_tpu's does. Besides, in the port: the check
runs after the steps t with t mod 100 == 0 on slot 0 of each written
stepping function, one host read each, and the loop stops at the first
check that sees the blow-up; a clean run with the scan
writes what a run without it writes, to the bit.
"""

import numpy as np
import pytest
import torch

import devito_tpu as dj
import devito_tpu_torch as dt
from devito_tpu_torch.compiler import executor

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

ERRCTL = ('advanced', {'errctl': 'max'})


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def unstable(pkg, expr, time_M=200):
    grid = pkg.Grid(shape=(10, 10))
    f = pkg.Function(name='f', grid=grid, space_order=2)
    u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
    v = pkg.TimeFunction(name='v', grid=grid, space_order=2)
    op = pkg.Operator(pkg.Eq(u.forward, eval(expr, {'u': u, 'v': v,
                                                    'f': f})), opt=ERRCTL)
    u.data[:] = 1.
    v.data[:] = 2.
    return op, u


@pytest.mark.parametrize("expr", ['u/f', '(u + v)/f'])
def test_stability(expr):
    for pkg in (dj, dt):
        op, _ = unstable(pkg, expr)
        with pytest.raises(pkg.ExecutionError):
            op.apply(time_M=200, dt=.1)


def test_stability_clean_run():
    out = []
    for pkg in (dj, dt):
        grid = pkg.Grid(shape=(10, 10))
        u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
        op = pkg.Operator(pkg.Eq(u.forward, u * 0.5), opt=ERRCTL)
        u.data[:] = 1.
        op.apply(time_M=200, dt=.1)  # no raise
        out.append(np.array(u.data))
    assert np.isfinite(out[1]).all()
    assert np.array_equal(out[0], out[1])


def test_halts_at_the_first_check_after_the_blow_up(monkeypatch):
    """u/f is inf from the first step on. The check reads slot 0 of u's
    buffer, as devito_tpu's does: at t = 0 it still holds the finite u[0],
    at t = 100 the inf u[100], so the run stops there and the check at
    t = 200 never runs; one host read a check."""
    checks = []
    orig = executor._unstable
    monkeypatch.setattr(executor, '_unstable',
                        lambda b, n: checks.append(n) or orig(b, n))
    op, u = unstable(dt, 'u/f')
    with pytest.raises(dt.ExecutionError, match="at step 100"):
        op.apply(time_M=250, dt=.1)
    assert checks == [('u',), ('u',)]
    assert np.isinf(np.array(u.data)).all()
    # from t = 1 the first check is at t = 100
    checks.clear()
    op2, _ = unstable(dt, 'u/f')
    with pytest.raises(dt.ExecutionError, match="at step 100"):
        op2.apply(time_m=1, time_M=250, dt=.1)
    assert checks == [('u',)]


def test_clean_run_equals_a_run_without_the_scan(monkeypatch):
    """The scan only reads: a run with it equals one without it, to the
    bit, with one check a multiple of 100 of the steps run."""
    checks = []
    orig = executor._unstable
    monkeypatch.setattr(executor, '_unstable',
                        lambda b, n: checks.append(n) or orig(b, n))
    out = []
    for opt in (ERRCTL, 'advanced'):
        grid = dt.Grid(shape=(12, 13), extent=(11., 12.))
        u = dt.TimeFunction(name='u', grid=grid, time_order=2,
                            space_order=4)
        u.data[:] = np.random.default_rng(3).random(u.shape)
        op = dt.Operator(dt.Eq(u.forward, dt.solve(u.dt2 - u.laplace,
                                                   u.forward)),
                         subs=grid.spacing_map, opt=opt)
        op.apply(time_m=1, time_M=305, dt=0.1)
        out.append(np.array(u.data))
    assert np.array_equal(out[0], out[1]) and np.isfinite(out[0]).all()
    assert len(checks) == 3                     # t = 100, 200, 300
