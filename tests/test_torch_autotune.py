"""``apply(autotune=...)`` and ``configuration['autotuning']`` through
devito_tpu_torch: accepted, and inert. The package has no tuner; like
devito_tpu's Pallas backend (operator.py:970-989) it logs that once an
operator and runs untuned, so a tuned apply writes what an untuned one
writes, to the bit, with the same kernel plans (tests/test_autotune.py's
``test_apply_autotune_green_and_inert_on_cpu``). devito_tpu's XLA
candidate sets (``_autotune_candidates``) are not ported.
"""

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu_torch.operator import operator as opmod

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def acoustic_op(shape=(20, 18, 16), so=4):
    grid = dt.Grid(shape=shape, extent=tuple(float(s - 1) for s in shape))
    u = dt.TimeFunction(name='u', grid=grid, time_order=2, space_order=so)
    vp = dt.Function(name='vp', grid=grid, space_order=so)
    stencil = dt.solve(1 / (vp * vp) * u.dt2 - u.laplace, u.forward)
    op = dt.Operator(dt.Eq(u.forward, stencil), subs=grid.spacing_map)
    vp.data[:] = 1.5
    u.data[1][10, 9, 8] = 1.0
    return op, u


def untuned():
    op, u = acoustic_op()
    op.apply(time_m=1, time_M=8, dt=0.05)
    return np.array(u.data)


@pytest.mark.parametrize('how', ['basic', 'aggressive', True, 'config'])
def test_autotune_accepted_and_inert(how, monkeypatch):
    logged = []
    monkeypatch.setattr(opmod, 'log_perf', logged.append)
    op, u = acoustic_op()
    plans = op.kernel_plans
    if how == 'config':
        with dt.switchconfig(autotuning='basic'):
            op.apply(time_m=1, time_M=8, dt=0.05)
            op.apply(time_m=1, time_M=1, dt=0.05)
    else:
        op.apply(time_m=1, time_M=8, dt=0.05, autotune=how)
        op.apply(time_m=1, time_M=1, dt=0.05, autotune=how)
    tuned = np.array(u.data)
    assert sum('no tuner' in m for m in logged) == 1
    assert op.kernel_plans == plans
    op2, u2 = acoustic_op()
    op2.apply(time_m=1, time_M=8, dt=0.05)
    op2.apply(time_m=1, time_M=1, dt=0.05)
    assert np.array_equal(tuned, np.array(u2.data))


def test_autotune_off_logs_nothing(monkeypatch):
    logged = []
    monkeypatch.setattr(opmod, 'log_perf', logged.append)
    op, _ = acoustic_op()
    op.apply(time_m=1, time_M=2, dt=0.05, autotune=False)
    op.apply(time_m=1, time_M=2, dt=0.05)
    assert not any('no tuner' in m for m in logged)
    assert 'autotune' in op._known_arguments()


def test_autotuning_configuration_values():
    with pytest.raises(dt.InvalidArgument):
        dt.configuration['autotuning'] = 'extreme'
    assert dt.configuration['autotuning'] == 'off'
