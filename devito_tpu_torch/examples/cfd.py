"""CFD building blocks, mirroring the reference's examples/cfd notebooks
(convection, diffusion, Burgers, Laplace, Poisson, cavity) as plain
functions returning the final fields; devito_tpu's examples/cfd.py
through the port, held against it by tests/test_torch_examples_cfd.py.
Every update here is a 2-D equation, on K1's point design.
"""

import numpy as np

from devito_tpu_torch import Grid, Function, TimeFunction, Eq, Operator, solve


def linear_convection(nx=81, ny=81, nt=100, c=1.0, sigma=.2):
    """2-D linear convection (reference: 01_convection.ipynb)."""
    grid = Grid(shape=(nx, ny), extent=(2., 2.))
    u = TimeFunction(name='u', grid=grid)
    dx = 2. / (nx - 1)
    dt = sigma * dx
    # hat initial condition
    d = u.data
    d[:] = 1.
    d[:, int(.5 / dx):int(1 / dx + 1), int(.5 / dx):int(1 / dx + 1)] = 2.
    eq = Eq(u.dt + c * u.dxl + c * u.dyl)
    stencil = solve(eq, u.forward)
    op = Operator(Eq(u.forward, stencil))
    op.apply(time_m=0, time_M=nt - 1, dt=dt)
    return u


def diffusion(nx=51, ny=51, nt=500, nu=0.05, sigma=.25):
    """2-D diffusion (reference: 03_diffusion.ipynb)."""
    grid = Grid(shape=(nx, ny), extent=(2., 2.))
    u = TimeFunction(name='u', grid=grid, space_order=2)
    dx = 2. / (nx - 1)
    dt = sigma * dx * dx / nu
    d = u.data
    d[:] = 1.
    d[:, int(.5 / dx):int(1 / dx + 1), int(.5 / dx):int(1 / dx + 1)] = 2.
    stencil = solve(Eq(u.dt, nu * u.laplace), u.forward)
    op = Operator(Eq(u.forward, stencil))
    op.apply(time_m=0, time_M=nt - 1, dt=dt)
    return u


def burgers(nx=41, ny=41, nt=120, nu=0.01, sigma=.0009):
    """2-D Burgers equation, coupled u/v (reference: 04_burgers.ipynb)."""
    grid = Grid(shape=(nx, ny), extent=(2., 2.))
    u = TimeFunction(name='u', grid=grid, space_order=2)
    v = TimeFunction(name='v', grid=grid, space_order=2)
    dx = 2. / (nx - 1)
    dt = sigma * dx * dx / nu
    for f in (u, v):
        d = f.data
        d[:] = 1.
        d[:, int(.5 / dx):int(1 / dx + 1), int(.5 / dx):int(1 / dx + 1)] = 2.
    eq_u = Eq(u.dt + u * u.dxl + v * u.dyl, nu * u.laplace)
    eq_v = Eq(v.dt + u * v.dxl + v * v.dyl, nu * v.laplace)
    op = Operator([Eq(u.forward, solve(eq_u, u.forward)),
                   Eq(v.forward, solve(eq_v, v.forward))])
    op.apply(time_m=0, time_M=nt - 1, dt=dt)
    return u, v


def poisson(nx=50, ny=50, niter=200):
    """2-D Poisson pseudo-timestepping (reference: 06_poisson.ipynb)."""
    grid = Grid(shape=(nx, ny), extent=(2., 1.))
    p = TimeFunction(name='p', grid=grid, space_order=2)
    b = Function(name='b', grid=grid)
    d = np.zeros((nx, ny))
    d[int(nx / 4), int(ny / 4)] = 100
    d[int(3 * nx / 4), int(3 * ny / 4)] = -100
    b.data[:] = d
    dx = 2. / (nx - 1)
    dy = 1. / (ny - 1)
    # Jacobi update (interior only; boundary p=0 via halo)
    x, y = grid.dimensions
    eq = Eq(p.forward,
            (dy ** 2 * (p.subs(x, x + 1) + p.subs(x, x - 1)) +
             dx ** 2 * (p.subs(y, y + 1) + p.subs(y, y - 1)) -
             b * dx ** 2 * dy ** 2) / (2 * (dx ** 2 + dy ** 2)),
            subdomain=grid.interior)
    op = Operator(eq)
    op.apply(time_m=0, time_M=niter - 1, dt=1.0)
    return p, b


def nonlinear_convection(nx=41, ny=41, nt=80, sigma=.2):
    """2-D nonlinear (coupled) convection with u=v=1 boundary conditions
    (reference: 02_convection_nonlinear.ipynb)."""
    grid = Grid(shape=(nx, ny), extent=(2., 2.))
    u = TimeFunction(name='u', grid=grid)
    v = TimeFunction(name='v', grid=grid)
    t = grid.stepping_dim
    x, y = grid.dimensions
    dx = 2. / (nx - 1)
    dt = sigma * dx
    for f in (u, v):
        d = f.data
        d[:] = 1.
        d[:, int(.5 / dx):int(1 / dx + 1), int(.5 / dx):int(1 / dx + 1)] = 2.
    upd_u = Eq(u.forward, solve(Eq(u.dt + u * u.dxl + v * u.dyl), u.forward),
               subdomain=grid.interior)
    upd_v = Eq(v.forward, solve(Eq(v.dt + u * v.dxl + v * v.dyl), v.forward),
               subdomain=grid.interior)
    bcs = []
    for f in (u, v):
        bcs += [Eq(f[t + 1, 0, y], 1.), Eq(f[t + 1, nx - 1, y], 1.),
                Eq(f[t + 1, x, ny - 1], 1.), Eq(f[t + 1, x, 0], 1.)]
    Operator([upd_u, upd_v] + bcs).apply(time_m=0, time_M=nt - 1, dt=dt)
    return u, v


def laplace(nx=31, ny=31, niter=500):
    """2-D Laplace steady state via Jacobi pseudo-timestepping with mixed
    Dirichlet/Neumann BCs (reference: 05_laplace.ipynb)."""
    grid = Grid(shape=(nx, ny), extent=(1., 2.))
    p = Function(name='p', grid=grid, space_order=2)
    pn = Function(name='pn', grid=grid, space_order=2)
    bc_right = Function(name='bc_right', grid=grid, space_order=0,
                        dimensions=(grid.dimensions[1],),
                        shape=(ny,))
    x, y = grid.dimensions
    bc_right.data[:] = np.linspace(0, 1, ny)

    eq = Eq(pn.laplace, subdomain=grid.interior)
    stencil = Eq(p, solve(eq, pn))
    bc = [Eq(p[0, y], 0.), Eq(p[nx - 1, y], bc_right[y]),
          Eq(p[x, 0], p[x, 1]), Eq(p[x, ny - 1], p[x, ny - 2])]
    op = Operator([stencil] + bc)
    for _ in range(niter):
        op.apply()
        pn.data[:] = p.data[:]
    return p


def cavity_flow(nx=41, ny=41, nt=500, rho=1.0, nu=.1, dt=.001):
    """2-D lid-driven cavity: Chorin-style velocity/pressure system with a
    moving-lid boundary (reference: 07_cavity_flow.ipynb)."""
    grid = Grid(shape=(nx, ny), extent=(2., 2.))
    u = TimeFunction(name='u', grid=grid, space_order=2)
    v = TimeFunction(name='v', grid=grid, space_order=2)
    p = TimeFunction(name='p', grid=grid, space_order=2)
    t = grid.stepping_dim
    x, y = grid.dimensions

    eq_u = Eq(u.dt + u * u.dx + v * u.dy,
              -1. / rho * p.dxc + nu * u.laplace, subdomain=grid.interior)
    eq_v = Eq(v.dt + u * v.dx + v * v.dy,
              -1. / rho * p.dyc + nu * v.laplace, subdomain=grid.interior)
    eq_p = Eq(p.laplace,
              rho * (1. / dt * (u.dxc + v.dyc) - (u.dxc * u.dxc)
                     - 2 * (u.dyc * v.dxc) - (v.dyc * v.dyc)),
              subdomain=grid.interior)
    update_u = Eq(u.forward, solve(eq_u, u.forward))
    update_v = Eq(v.forward, solve(eq_v, v.forward))
    update_p = Eq(p.forward, solve(eq_p, p))

    bc_u = [Eq(u[t + 1, 0, y], 0), Eq(u[t + 1, nx - 1, y], 0),
            Eq(u[t + 1, x, 0], 0), Eq(u[t + 1, x, ny - 1], 1)]
    bc_v = [Eq(v[t + 1, 0, y], 0), Eq(v[t + 1, nx - 1, y], 0),
            Eq(v[t + 1, x, ny - 1], 0), Eq(v[t + 1, x, 0], 0)]
    bc_p = [Eq(p[t + 1, 0, y], p[t + 1, 1, y]),
            Eq(p[t + 1, nx - 1, y], p[t + 1, nx - 2, y]),
            Eq(p[t + 1, x, 0], p[t + 1, x, 1]),
            Eq(p[t + 1, x, ny - 1], 0)]
    op = Operator([update_p] + bc_p + [update_u, update_v] + bc_u + bc_v)
    op.apply(time_m=0, time_M=nt - 1, dt=dt)
    return u, v, p


def shallow_water(nx=101, ny=101, nt=200, g=9.81, alpha=0.025,
                  depth=100.0, dt=None):
    """2-D shallow-water equations (FTCS, Manning friction), with a
    Gaussian initial wave (reference: 08_shallow_water_equation.ipynb)."""
    from devito_tpu_torch import sqrt
    L = 1000.
    grid = Grid(shape=(nx, ny), extent=(L, L))
    eta = TimeFunction(name='eta', grid=grid, space_order=2)
    M = TimeFunction(name='M', grid=grid, space_order=2)
    N = TimeFunction(name='N', grid=grid, space_order=2)
    h = Function(name='h', grid=grid)
    D = Function(name='D', grid=grid)

    xx, yy = np.meshgrid(np.linspace(0, L, nx), np.linspace(0, L, ny),
                         indexing='ij')
    eta0 = 2.0 * np.exp(-((xx - L / 2) ** 2 + (yy - L / 2) ** 2)
                        / (2 * (L / 20) ** 2))
    h.data[:] = depth
    D.data[:] = eta0 + depth
    eta.data[0] = eta0

    friction = g * alpha ** 2 * sqrt(M ** 2 + N ** 2) / D ** (7. / 3.)
    pde_eta = Eq(eta.dt + M.dxc + N.dyc)
    pde_M = Eq(M.dt + (M ** 2 / D).dxc + (M * N / D).dyc
               + g * D * eta.forward.dxc + friction * M)
    pde_N = Eq(N.dt + (M.forward * N / D).dxc + (N ** 2 / D).dyc
               + g * D * eta.forward.dyc + friction * N)
    upd = [Eq(eta.forward, solve(pde_eta, eta.forward),
              subdomain=grid.interior),
           Eq(M.forward, solve(pde_M, M.forward), subdomain=grid.interior),
           Eq(N.forward, solve(pde_N, N.forward), subdomain=grid.interior),
           Eq(D, eta.forward + h)]
    if dt is None:
        dt = 0.2 * (L / (nx - 1)) / np.sqrt(g * (depth + 2.0))
    Operator(upd).apply(time_m=0, time_M=nt - 1, dt=dt)
    return eta, M, N


def darcy_flow(n=64, niter=2000):
    """2-D Darcy pressure equation -div(a grad(u)) = f with a two-valued
    permeability field, solved by pseudo-timestepping on a staggered
    gradient (reference: 09_Darcy_flow_equation.ipynb)."""
    from devito_tpu_torch import div, grad
    grid = Grid(shape=(n, n), extent=(1., 1.))
    u = TimeFunction(name='u', grid=grid, space_order=2)
    a = Function(name='a', grid=grid, space_order=2)
    f1 = Function(name='f1', grid=grid)
    t = grid.stepping_dim
    x, y = grid.dimensions

    # two-valued permeability from a smoothed random field (the notebook
    # thresholds a Gaussian random field at 0: 12 above, 3 below)
    rng = np.random.default_rng(3)
    field = rng.standard_normal((n, n))
    k = np.ones((5, 5)) / 25.
    sm = field.copy()
    for _ in range(4):
        pad = np.pad(sm, 2, mode='edge')
        sm = sum(pad[i:i + n, j:j + n] * k[i, j]
                 for i in range(5) for j in range(5))
    a.data[:] = np.where(sm >= 0, 12., 3.)
    f1.data[:] = 1.0

    equation_u = Eq(-div(a * grad(u, shift=.5), shift=-.5), f1)
    stencil = solve(equation_u, u)
    update = Eq(u.forward, stencil)
    bc = [Eq(u[t + 1, 0, y], 0.), Eq(u[t + 1, n - 1, y], 0.),
          Eq(u[t + 1, x, 0], 0.), Eq(u[t + 1, x, n - 1], 0.)]
    Operator([update] + bc).apply(time_m=0, time_M=niter - 1, dt=1.0)
    return u, a
