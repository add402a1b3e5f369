"""A ConditionalDimension with both ``factor`` and ``condition`` in the
port's time loop (devito_tpu_torch/compiler/executor.py ``_write_due``)
against devito_tpu: the saved rows of each problem equal the reference's
exactly, the steps the condition turns off leave their rows unwritten,
and a step past the saved rows touches none, whether the condition reads
time alone or space."""

import numpy as np
import pytest
import sympy
import torch

import devito_tpu as dj
import devito_tpu_torch as dt

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _past_the_rows(pkg):
    """factor 2, condition 2 <= t <= 6, 4 saved rows, 10 steps: t // 2
    reaches row 4 at t = 8, where the condition is off."""
    grid = pkg.Grid(shape=(4, 4))
    time = grid.time_dim
    cd = pkg.ConditionalDimension(
        name='tc', parent=time, factor=2,
        condition=sympy.And(sympy.Ge(time, 2), sympy.Le(time, 6)))
    u = pkg.TimeFunction(name='u', grid=grid)
    us = pkg.TimeFunction(name='us', grid=grid, time_dim=cd, save=4)
    pkg.Operator([pkg.Eq(u.forward, u + 1), pkg.Eq(us, u)]).apply(
        time_M=9, dt=1)
    return np.asarray(us.data)


def _bounds(pkg):
    """tests/test_conddim_port.py TestConditions.test_factor_and_condition:
    factor 5, condition 10 <= t <= 100, over 199 steps into 22 rows."""
    grid = pkg.Grid(shape=(10, 10))
    time = grid.time_dim
    factor, bounds = 5, (10, 100)
    cd = pkg.ConditionalDimension(
        name='timeu', parent=time, factor=factor,
        condition=sympy.And(sympy.Ge(time, bounds[0]),
                            sympy.Le(time, bounds[1])))
    u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
    us = pkg.TimeFunction(name='usaved', grid=grid, space_order=2,
                          time_dim=cd,
                          save=(bounds[1] - bounds[0] + factor) // factor + 2)
    pkg.Operator([pkg.Eq(u.forward, u + 1), pkg.Eq(us, u)]).apply(
        time_m=1, time_M=199, dt=1)
    return np.asarray(us.data)


def _constant_bound(pkg):
    """factor 3, condition t >= c for a Constant c set at apply (4), 4
    rows over 12 steps: row 0 (t = 0) and row 1 (t = 3) stay 0."""
    grid = pkg.Grid(shape=(5, 6))
    time = grid.time_dim
    c = pkg.Constant(name='c', value=2.0)
    cd = pkg.ConditionalDimension(name='tc', parent=time, factor=3,
                                  condition=sympy.Ge(time, c))
    u = pkg.TimeFunction(name='u', grid=grid)
    us = pkg.TimeFunction(name='us', grid=grid, time_dim=cd, save=4)
    u.data[0] = np.arange(30.).reshape(5, 6)
    pkg.Operator([pkg.Eq(u.forward, 2 * u + 1), pkg.Eq(us, u)]).apply(
        time_M=11, dt=1, c=4.0)
    return np.asarray(us.data)


def _space_condition(pkg):
    """factor 2, condition x >= 1, 4 saved rows, 10 steps: a condition
    that reads space, and t = 8 past the rows, which the reference
    drops."""
    grid = pkg.Grid(shape=(4, 5))
    x, _ = grid.dimensions
    cd = pkg.ConditionalDimension(name='tc', parent=grid.time_dim,
                                  factor=2, condition=sympy.Ge(x, 1))
    u = pkg.TimeFunction(name='u', grid=grid)
    us = pkg.TimeFunction(name='us', grid=grid, time_dim=cd, save=4)
    u.data[0] = np.arange(20.).reshape(4, 5)
    pkg.Operator([pkg.Eq(u.forward, u + 1), pkg.Eq(us, u)]).apply(
        time_M=9, dt=1)
    return np.asarray(us.data)


@pytest.mark.parametrize('build', [_past_the_rows, _bounds, _constant_bound,
                                   _space_condition])
def test_factor_and_condition_match_reference(build):
    want = build(dj)
    dt.clear_cache()
    got = build(dt)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


def test_rows_past_the_condition_stay_unwritten():
    """The repro's rows: t = 0 is off (row 0 stays 0), t = 2, 4, 6 write u
    at t, and t = 8 (row 4) is off and writes nothing."""
    got = _past_the_rows(dt)
    assert got[:, 0, 0].tolist() == [0.0, 2.0, 4.0, 6.0]
