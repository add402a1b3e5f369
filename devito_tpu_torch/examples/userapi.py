"""User-API walkthrough: executable condensations of the reference's
``examples/userapi`` notebook series (00_sympy … 09_fd_evaluation), one
function per notebook topic. Each returns data a test can check, so the
whole tour doubles as an API smoke suite.
"""

import numpy as np
import sympy

from devito_tpu_torch import (Grid, Function, TimeFunction, SparseFunction,
                              Eq, Operator, solve, ConditionalDimension,
                              SubDomain, Derivative)

__all__ = ['dsl_overview', 'apply_and_arguments', 'subdomains_demo',
           'boundary_conditions_demo', 'conditional_dimension_demo',
           'sparse_operations_demo', 'staggered_interpolation_demo',
           'fd_evaluation_demo']


def dsl_overview():
    """01_dsl: symbolic functions, derivatives, and a diffusion operator."""
    grid = Grid(shape=(32, 32), extent=(1., 1.))
    u = TimeFunction(name='u', grid=grid, space_order=2)
    # derivative shortcuts are sympy expressions
    assert isinstance(u.dx, Derivative)
    expanded = u.dx2.evaluate
    assert 'h_x' in str(expanded)
    eq = Eq(u.dt, 0.5 * u.laplace)
    stencil = solve(eq, u.forward)
    op = Operator(Eq(u.forward, stencil))
    u.data[0, 16, 16] = 1.
    op.apply(time_M=10, dt=1e-5)
    return u


def apply_and_arguments():
    """02_apply: runtime arguments, overrides, and summaries."""
    grid = Grid(shape=(24, 24), extent=(23., 23.))
    u = TimeFunction(name='u', grid=grid)
    op = Operator(Eq(u.forward, u + 1))
    summary = op.apply(time_M=4, dt=1.)
    # per-apply data overrides without recompilation
    w = TimeFunction(name='u', grid=grid)
    op.apply(u=w, time_M=9, dt=1.)
    return u, w, summary


def subdomains_demo():
    """03/07_subdomains: interior and custom thickness regions."""

    class Left(SubDomain):
        name = 'left'

        def define(self, dims):
            x, y = dims
            return {x: ('left', 8), y: y}

    grid = Grid(shape=(16, 16), extent=(15., 15.), subdomains=(Left(),))
    f = Function(name='f', grid=grid)
    g = Function(name='g', grid=grid)
    Operator([Eq(f, 1, subdomain=grid.interior),
              Eq(g, 2, subdomain=grid.subdomains['left'])]).apply()
    return f, g


def boundary_conditions_demo():
    """04_boundary_conditions: low-level indexed Dirichlet/Neumann rows."""
    grid = Grid(shape=(16, 16), extent=(15., 15.))
    x, y = grid.dimensions
    t = grid.stepping_dim
    u = TimeFunction(name='u', grid=grid, space_order=2)
    stencil = solve(Eq(u.dt, 0.5 * u.laplace), u.forward)
    bc = [Eq(u[t + 1, 0, y], 1.),            # Dirichlet
          Eq(u[t + 1, 15, y], u[t + 1, 14, y]),  # Neumann
          Eq(u[t + 1, x, 0], 1.),
          Eq(u[t + 1, x, 15], u[t + 1, x, 14])]
    Operator([Eq(u.forward, stencil)] + bc).apply(time_M=20, dt=1e-4)
    return u


def conditional_dimension_demo():
    """05_conditional_dimension: subsampled saves."""
    grid = Grid(shape=(16, 16), extent=(15., 15.))
    u = TimeFunction(name='u', grid=grid)
    tsub = ConditionalDimension('tsub', parent=grid.time_dim, factor=5)
    usave = TimeFunction(name='usave', grid=grid, save=5, time_dim=tsub)
    Operator([Eq(u.forward, u + 1), Eq(usave, u)]).apply(time_M=20, dt=1.)
    return usave


def sparse_operations_demo():
    """06_sparse_operations: interpolation and injection."""
    grid = Grid(shape=(21, 21), extent=(20., 20.))
    f = Function(name='f', grid=grid, space_order=2)
    xs, ys = np.meshgrid(np.arange(21.), np.arange(21.), indexing='ij')
    f.data[:] = xs + ys
    p = SparseFunction(name='p', grid=grid, npoint=3)
    p.coordinates.data[:] = [[5.5, 5.5], [10., 10.], [0.25, 0.25]]
    Operator([p.interpolate(expr=f)]).apply()
    interp_vals = np.asarray(p.data).copy()

    g = Function(name='g', grid=grid, space_order=2)
    Operator([p.inject(field=g, expr=sympy.Float(1.))]).apply()
    return interp_vals, g


def staggered_interpolation_demo():
    """08_staggered_interp: staggered fields and parameter averaging."""
    grid = Grid(shape=(16, 16), extent=(15., 15.))
    x, y = grid.dimensions
    vx = Function(name='vx', grid=grid, space_order=2, staggered=x)
    b = Function(name='b', grid=grid, space_order=2)
    b.data[:] = 2.
    # staggered derivative evaluated on its own lattice vs projected
    own = vx.dx.evaluate
    node = vx.dx(x0={x: x}).evaluate if callable(vx.dx) else None
    return own, b


def fd_evaluation_demo():
    """09_fd_evaluation: orders, sides, x0 and transposes."""
    grid = Grid(shape=(16, 16), extent=(15., 15.))
    x, y = grid.dimensions
    f = Function(name='f', grid=grid, space_order=8)
    out = {
        'dx_so8': str(f.dx.evaluate),
        'dx_order2': str(f.dx(fd_order=2).evaluate),
        'dx_left': str(f.dxl.evaluate),
        'dx_right': str(f.dxr.evaluate),
        'dx_half': str(f.dx(x0={x: x + x.spacing / 2}).evaluate),
        'dx_T': str(f.dx.T.evaluate),
    }
    return out
