"""Superstepping (timestepping.py) through devito_tpu_torch: the k-step
composed stencil of ``superstep_generator`` advances k steps in one
application.

tests/test_superstep.py's case for k = 1-4 (a 2-D fp64 wave equation):
the superstep's solution equals k single steps within 1e-10 (as there),
and equals devito_tpu's superstep within 1e-12 x max, each package
building its own problem. Both composed equations are planned for K1: the
wide, off-axis stencil on the point design, neither reading the row it
writes (``decline_reason`` is None; the second reads the first's time-t
row, not the row the first writes); in 3-D too, where the second equation
of k = 2 is the one-step star and streams.
"""

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu.timestepping import superstep_generator as gen_j  # noqa: E402
from devito_tpu_torch.kernels import stencil as K  # noqa: E402
from devito_tpu_torch.timestepping import (  # noqa: E402
    superstep_generator as gen_t, superstep_solution_transfer)

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def gauss(n):
    x = np.arange(n)
    c = n // 2
    return np.exp(-((x[:, None] - c) ** 2 + (x[None, :] - c) ** 2) / 20.)


def single_steps(pkg, k, n=41):
    g = pkg.Grid(shape=(n, n), extent=(n - 1.,) * 2, dtype=np.float64)
    u = pkg.TimeFunction(name='u', grid=g, time_order=2, space_order=2)
    st = pkg.solve(u.dt2 - 0.2 * u.laplace, u.forward).subs(
        g.spacing_map).subs({g.time_dim.spacing: 0.3})
    u.data[0] = gauss(n)
    u.data[1] = gauss(n)
    pkg.Operator(pkg.Eq(u.forward, st)).apply(time_m=1, time_M=k, dt=0.3)
    return np.array(u.data[(k + 1) % 3])


def superstep(pkg, generator, k, n=41):
    g = pkg.Grid(shape=(n, n), extent=(n - 1.,) * 2, dtype=np.float64)
    w = pkg.TimeFunction(name='w', grid=g, time_order=2, space_order=2)
    w.data[0] = gauss(n)
    w.data[1] = gauss(n)
    st = pkg.solve(w.dt2 - 0.2 * w.laplace, w.forward).subs(
        g.spacing_map).subs({g.time_dim.spacing: 0.3})
    uss, ussp, eq1, eq2 = generator(w, st, k, nt=1)
    op = pkg.Operator([eq1, eq2])
    op.apply(time_m=1, time_M=1, dt=0.3)
    return np.array(uss.data[2]), op


@pytest.mark.parametrize('k', [1, 2, 3, 4])
def test_superstep_equals_k_steps(k):
    ref = single_steps(dt, k)
    got, op = superstep(dt, gen_t, k)
    assert np.abs(got - ref).max() < 1e-10
    want, _ = superstep(dj, gen_j, k)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # both composed equations run in K1
    assert [p is not None for _, p in op.kernel_plans] == [True, True]


@pytest.mark.parametrize('k', [2, 4])
def test_composed_equations_plan_for_the_point_design(k):
    """At 3-D SO=4 the k-step stencil reaches 2k points along each axis
    and off the axes: the first equation takes the point design. The
    second is the (k-1)-step stencil: at k = 2 the one-step star, which
    streams, at k = 4 off the axes too."""
    n = 12
    g = dt.Grid(shape=(n,) * 3, extent=(10. * (n - 1),) * 3)
    u = dt.TimeFunction(name='u', grid=g, time_order=2, space_order=4)
    st = dt.solve(u.dt2 - 2.0 * u.laplace, u.forward).subs(
        g.spacing_map).subs({g.time_dim.spacing: 0.5})
    uss, ussp, eq1, eq2 = gen_t(u, st, k, nt=1)
    op = dt.Operator([eq1, eq2])
    designs = []
    for eq, plan in op.kernel_plans:
        assert K.decline_reason(eq) is None
        designs.append(plan.design)
    assert designs == ['point', 'stream' if k == 2 else 'point']
    assert uss.space_order == 4 * k


def test_solution_transfer_rows():
    """superstep_solution_transfer puts u(nt) and u(nt - 1) into the pair's
    rows nt mod 3."""
    g = dt.Grid(shape=(5, 6))
    u = dt.TimeFunction(name='u', grid=g, time_order=2, space_order=2)
    new = dt.TimeFunction(name='n', grid=g, time_order=2, space_order=4)
    new_p = dt.TimeFunction(name='np_', grid=g, time_order=2, space_order=4)
    u.data[:] = np.arange(3)[:, None, None] + np.zeros((3, 5, 6))
    superstep_solution_transfer(u, new, new_p, 4)
    assert (new.data[1] == 1).all() and (new_p.data[1] == 0).all()
