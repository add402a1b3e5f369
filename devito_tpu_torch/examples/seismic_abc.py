"""Absorbing-boundary-condition methods for the 2-D acoustic equation,
mirroring the reference's tutorial suite
(examples/seismic/abc_methods/02_damping.ipynb, 03_pml.ipynb,
04_habc.ipynb) as runnable functions.

All three run the same experiment: a Ricker source in a homogeneous
velocity model, fields returned after ``nt`` steps so tests can measure
how much energy the boundary treatment reflects back into the interior
compared to the untreated (reflecting) case.

- ``damping_abc``: Sochacki damping term ``damp * u.dt`` active in an
  ``nbl``-wide strip (notebook 02).
- ``pml_abc``: split-field PML with auxiliary fluxes phi1/phi2 driven by
  per-axis damping profiles (notebook 03, full-domain formulation — the
  profiles vanish in the interior so the auxiliary fields stay zero
  there).
- ``habc``: hybrid ABC — blend of the interior update with a one-way
  (A1) update over the absorbing strip, linear blending weights
  ``w = (n-i)/n`` (notebook 04, habcw=1).
"""

import numpy as np

from devito_tpu_torch import Grid, Function, TimeFunction, Eq, Operator, solve
from devito_tpu_torch.models.seismic.source import RickerSource, TimeAxis

__all__ = ['damping_abc', 'pml_abc', 'habc', 'reflecting']


def _setup(shape, extent, nt, dt, f0=0.015, vel=1.5):
    grid = Grid(shape=shape, extent=extent, dtype=np.float64)
    time_range = TimeAxis(start=0., step=dt, num=nt + 1)
    src = RickerSource(name='src', grid=grid, f0=f0, npoint=1,
                       time_range=time_range)
    src.coordinates.data[0, :] = [extent[0] / 2, extent[1] / 2]
    return grid, src


def _damp_profile(n, nbl, hinv):
    """Sochacki ramp, 0 in the interior growing into the strips."""
    prof = np.zeros(n)
    coeff = 1.5 * np.log(1. / 0.001) / nbl
    for i in range(nbl):
        pos = (nbl - i) / nbl
        val = coeff * (pos - np.sin(2 * np.pi * pos) / (2 * np.pi)) * hinv
        prof[i] = val
        prof[n - 1 - i] = val
    return prof


def reflecting(shape=(101, 101), extent=(1000., 1000.), nt=600, dt=1.0,
               vel=1.5):
    """No boundary treatment: waves reflect off the domain edges."""
    grid, src = _setup(shape, extent, nt, dt)
    u = TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    pde = u.dt2 - vel ** 2 * u.laplace
    eqs = [Eq(u.forward, solve(pde, u.forward))]
    eqs += [src.inject(field=u.forward, expr=src * dt ** 2 * vel ** 2)]
    Operator(eqs, subs=grid.spacing_map, name='Reflecting').apply(
        time_m=0, time_M=nt - 1, dt=dt)
    return u


def damping_abc(shape=(101, 101), extent=(1000., 1000.), nt=600, dt=1.0,
                vel=1.5, nbl=20):
    """Damping strip (reference notebook 02)."""
    grid, src = _setup(shape, extent, nt, dt)
    u = TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    damp = Function(name='damp', grid=grid)
    hx = extent[0] / (shape[0] - 1)
    px = _damp_profile(shape[0], nbl, 1. / hx)
    pz = _damp_profile(shape[1], nbl, 1. / hx)
    damp.data[:] = px[:, None] + pz[None, :]

    pde = u.dt2 - vel ** 2 * u.laplace + damp * u.dt
    eqs = [Eq(u.forward, solve(pde, u.forward))]
    eqs += [src.inject(field=u.forward, expr=src * dt ** 2 * vel ** 2)]
    Operator(eqs, subs=grid.spacing_map, name='DampingABC').apply(
        time_m=0, time_M=nt - 1, dt=dt)
    return u


def pml_abc(shape=(101, 101), extent=(1000., 1000.), nt=600, dt=1.0,
            vel=1.5, nbl=20):
    """Split-field PML (reference notebook 03).

    u_tt + (dx+dz) u_t + dx dz u = c² lap u + div(phi)
    phi1_t + dx phi1 = (dz-dx) c² u_x ; phi2_t + dz phi2 = (dx-dz) c² u_z
    with per-axis profiles dx(x), dz(z).
    """
    grid, src = _setup(shape, extent, nt, dt)
    u = TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    phi1 = TimeFunction(name='phi1', grid=grid, time_order=1, space_order=2)
    phi2 = TimeFunction(name='phi2', grid=grid, time_order=1, space_order=2)
    dampx = Function(name='dampx', grid=grid)
    dampz = Function(name='dampz', grid=grid)
    hx = extent[0] / (shape[0] - 1)
    dampx.data[:] = _damp_profile(shape[0], nbl, 1. / hx)[:, None]
    dampz.data[:] = _damp_profile(shape[1], nbl, 1. / hx)[None, :]

    pde_u = (u.dt2 + (dampx + dampz) * u.dtc + (dampx * dampz) * u
             - vel ** 2 * u.laplace - phi1.dxc - phi2.dyc)
    pde_p1 = phi1.dt + dampx * phi1 - (dampz - dampx) * vel ** 2 * u.dxc
    pde_p2 = phi2.dt + dampz * phi2 - (dampx - dampz) * vel ** 2 * u.dyc

    eqs = [Eq(u.forward, solve(pde_u, u.forward)),
           Eq(phi1.forward, solve(pde_p1, phi1.forward)),
           Eq(phi2.forward, solve(pde_p2, phi2.forward))]
    eqs += [src.inject(field=u.forward, expr=src * dt ** 2 * vel ** 2)]
    Operator(eqs, subs=grid.spacing_map, name='PmlABC').apply(
        time_m=0, time_M=nt - 1, dt=dt)
    return u


def habc(shape=(101, 101), extent=(1000., 1000.), nt=600, dt=1.0,
         vel=1.5, nbl=20):
    """Hybrid ABC (reference notebook 04, habcw=1 linear weights):
    the absorbing strip blends the full interior update with a one-way
    (A1) outgoing-wave update, ``u = (1-w) u_int + w u_oneway``."""
    grid, src = _setup(shape, extent, nt, dt)
    x, z = grid.dimensions
    u = TimeFunction(name='u', grid=grid, time_order=2, space_order=4)
    w = Function(name='wgt', grid=grid)       # blend weight, 0 interior
    sx = Function(name='sx', grid=grid)       # outward direction x
    sz = Function(name='sz', grid=grid)       # outward direction z

    n0, n1 = shape
    wgt = np.zeros(shape)
    sxd = np.zeros(shape)
    szd = np.zeros(shape)
    for i in range(nbl):
        ww = (nbl - i) / nbl
        wgt[i, :] = np.maximum(wgt[i, :], ww)
        wgt[n0 - 1 - i, :] = np.maximum(wgt[n0 - 1 - i, :], ww)
        wgt[:, i] = np.maximum(wgt[:, i], ww)
        wgt[:, n1 - 1 - i] = np.maximum(wgt[:, n1 - 1 - i], ww)
        sxd[i, :] = -1.
        sxd[n0 - 1 - i, :] = 1.
        szd[:, i] = -1.
        szd[:, n1 - 1 - i] = 1.
    w.data[:] = wgt
    sx.data[:] = sxd
    sz.data[:] = szd

    # interior (full physics) update
    u_int = solve(u.dt2 - vel ** 2 * u.laplace, u.forward)
    # A1 one-way update: u_t + c (s·grad) u = 0
    u_ow = u - dt * vel * (sx * u.dxc + sz * u.dyc)

    eqs = [Eq(u.forward, (1 - w) * u_int + w * u_ow)]
    eqs += [src.inject(field=u.forward, expr=src * dt ** 2 * vel ** 2)]
    Operator(eqs, subs=grid.spacing_map, name='HybridABC').apply(
        time_m=0, time_M=nt - 1, dt=dt)
    return u


def interior_energy(u, nbl=20):
    """Sum of squares over the interior (ABC-quality metric)."""
    d = np.asarray(u.data)[0]
    return float(np.sum(d[nbl:-nbl, nbl:-nbl] ** 2))
