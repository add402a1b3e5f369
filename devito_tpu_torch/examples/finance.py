"""Black-Scholes initial-value boundary problem solved as a PDE
(reference: examples/finance/bs_ivbp.ipynb).

dV/dt + r S dV/dS + sigma^2 S^2 / 2 d2V/dS2 - r V = 0, marched backwards
from the payoff max(S-K, 0), with linear-extrapolation (Neumann-like)
boundary handling on the right edge.

K1 takes 2-D and 3-D regions, and this update is 1-D (its right-hand
side reads the coordinate ``s`` besides): the torch translator runs it.
"""

import numpy as np

from devito_tpu_torch import (Eq, Grid, TimeFunction, Operator, solve,
                              Constant, SpaceDimension)

__all__ = ['black_scholes', 'call_value_bs']


def black_scholes(K=100.0, r=0.12, sigma=0.1, smin=60.0, smax=140.0,
                  tmax=1.0, dt0=0.0005, ds0=1.0):
    """March the Black-Scholes PDE; returns (v, s_axis, nt).

    ``v`` has ``save=nt`` so every timestep (option value at each time to
    expiry) is retained, as the reference notebook does for plotting and
    for validation against the closed-form call value.
    """
    nt = int(tmax / dt0) + 1
    ns = int((smax - smin) / ds0) + 1
    extent = int(ds0 * (ns - 1))

    s = SpaceDimension(name='s',
                       spacing=Constant(name='h_s', value=ds0))
    grid = Grid(shape=(ns,), origin=(smin,), extent=(extent,),
                dimensions=(s,))

    v = TimeFunction(name='v', grid=grid, space_order=2, time_order=1,
                     save=nt)
    t, s = v.dimensions

    vds = v.dsc
    vds2 = v.ds2

    # Centered-derivative PDE (reference notebook cell 3)
    pde = (-v.dt + r * (smin + ds0 * s) * vds
           + 0.5 * sigma ** 2 * (smin + ds0 * s) ** 2 * vds2 - r * v)
    update = solve(pde, v.forward)

    # Linear extrapolation into the two right halo points (reference
    # notebook: Neumann boundary equations)
    eqs = [Eq(v[t, extent], v[t, extent - 1]
              + (v[t, extent - 1] - v[t, extent - 2])),
           Eq(v.forward, update)]

    op = Operator(eqs, subs=v.grid.spacing_map, name='BlackScholes')

    s_axis = np.linspace(smin, smax, ns)
    v.data[0, :] = np.maximum(s_axis - K, 0.)
    op.apply(time_m=0, time_M=nt - 2, dt=dt0)
    return v, s_axis, nt


def call_value_bs(S, K, T, r, sigma):
    """Closed-form European call value (validation reference)."""
    from math import erf

    def cdf(z):
        return 0.5 * (1.0 + erf(z / np.sqrt(2.0)))

    S = np.asarray(S, dtype=np.float64)
    d1 = (np.log(S / K) + (r + 0.5 * sigma ** 2) * T) / (sigma * np.sqrt(T))
    d2 = (np.log(S / K) + (r - 0.5 * sigma ** 2) * T) / (sigma * np.sqrt(T))
    return (S * np.vectorize(cdf)(d1)
            - K * np.exp(-r * T) * np.vectorize(cdf)(d2))
