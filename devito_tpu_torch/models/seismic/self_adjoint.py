"""Self-adjoint (energy-conserving) variable-density viscoacoustic
propagator.

Reference parity: examples/seismic/self_adjoint/ (operators.py iso_stencil
— ``b/v^2 [P.dt2 + w/Q P.dt] = div(b grad P) + s`` with half-shifted
first-derivative composition; utils.py setup_w_over_q — logarithmic Q taper
absorbing boundary).

On the card each dense equation runs in K1 (kernels/stencil.py): CIRE's
three ``b * d(u)/dx_i`` temporaries, computed into the halo, and the
update, which reads four staged groups, on the point design.
"""

import numpy as np

from ...types import Eq, Function, TimeFunction, Grid
from ...operator import Operator
from ...utils import memoized_meth
from .utils import solver_spans

__all__ = ['setup_w_over_q', 'sa_iso_stencil', 'IsoFwdOperator',
           'IsoAdjOperator', 'SaIsoWaveSolver', 'sa_setup']


def setup_w_over_q(wOverQ, w, qmin, qmax, npad, sigma=0):
    """Fill the w/Q attenuation field: Q varies logarithmically from qmax
    in the interior to qmin at the boundary over npad points (reference:
    self_adjoint/utils.py:8)."""
    lqmin, lqmax = np.log(qmin), np.log(qmax)
    data = np.ones(wOverQ.data.shape, dtype=np.float64)
    for j, n in enumerate(data.shape):
        idx = np.arange(n, dtype=np.float64)
        dist = np.minimum(idx, n - 1 - idx) / float(npad)
        shape = [1] * data.ndim
        shape[j] = n
        data = np.minimum(data, dist.reshape(shape))
    data = w / np.exp(lqmin + data * (lqmax - lqmin))
    wOverQ.data[:] = data.astype(wOverQ.dtype)
    wOverQ.pad_outer_halo()


def sa_iso_stencil(field, vp, b, wOverQ, forward=True, q=0):
    """Reference: self_adjoint/operators.py iso_stencil:4."""
    from sympy import Rational
    from ...finite_differences.derivative import Derivative

    field_next = field.forward if forward else field.backward
    field_prev = field.backward if forward else field.forward
    t = field.time_dim
    dims = field.space_dimensions
    s = t.spacing

    lap = 0
    for d in dims:
        inner = b * Derivative(field, d, fd_order=field.space_order,
                               x0={d: Rational(1, 2)})
        lap += Derivative(inner, d, fd_order=field.space_order,
                          x0={d: Rational(-1, 2)})

    eq_time_update = (s ** 2 * vp ** 2 / b) * (lap + q) + \
        (2 - s * wOverQ) * field + (s * wOverQ - 1) * field_prev
    return [Eq(field_next, eq_time_update)]


def IsoFwdOperator(model, geometry, space_order=8, save=False, **kwargs):
    """Reference: self_adjoint IsoFwdOperator."""
    vp, b, wOverQ = model.vp, model.b, model.damp
    src, rec = geometry.src, geometry.rec
    u = TimeFunction(name='u', grid=model.grid,
                     save=geometry.nt if save else None,
                     time_order=2, space_order=space_order)
    t = u.time_dim
    eqn = sa_iso_stencil(u, vp, b, wOverQ, forward=True)
    src_term = src.inject(field=u.forward,
                          expr=src * t.spacing ** 2 * vp ** 2 / b)
    rec_term = rec.interpolate(expr=u)
    op = Operator(eqn + [src_term, rec_term], subs=model.spacing_map,
                  name='IsoFwdOperator', **kwargs)
    op._fields = (u,)
    return op


def IsoAdjOperator(model, geometry, space_order=8, save=False, **kwargs):
    """Reference: self_adjoint IsoAdjOperator — the same stencil run
    backward (the operator is self-adjoint up to source/receiver
    scaling)."""
    vp, b, wOverQ = model.vp, model.b, model.damp
    src, rec = geometry.src, geometry.rec
    v = TimeFunction(name='v', grid=model.grid,
                     save=geometry.nt if save else None,
                     time_order=2, space_order=space_order)
    t = v.time_dim
    eqn = sa_iso_stencil(v, vp, b, wOverQ, forward=False)
    rec_term = rec.inject(field=v.backward,
                          expr=rec * t.spacing ** 2 * vp ** 2 / b)
    src_term = src.interpolate(expr=v)
    op = Operator(eqn + [rec_term, src_term], subs=model.spacing_map,
                  name='IsoAdjOperator', **kwargs)
    op._fields = (v,)
    return op


@solver_spans
class SaIsoWaveSolver:

    def __init__(self, model, geometry, space_order=8, **kwargs):
        self.model = model
        # reference: SaIsoAcousticWaveSolver halves the critical dt (the
        # strong boundary attenuation needs s*w/qmin < 2 for stability)
        self.model.dt_scale = .5
        self.geometry = geometry
        self.space_order = space_order
        self._kwargs = kwargs

    @property
    def dt(self):
        return self.model.critical_dt

    @memoized_meth
    def op_fwd(self, save=None):
        return IsoFwdOperator(self.model, self.geometry,
                              space_order=self.space_order, save=save,
                              **self._kwargs)

    @memoized_meth
    def op_adj(self):
        return IsoAdjOperator(self.model, self.geometry,
                              space_order=self.space_order,
                              **self._kwargs)

    def forward(self, src=None, rec=None, u=None, save=None, **kwargs):
        src = src if src is not None else self.geometry.src
        rec = rec if rec is not None else self.geometry.rec
        op = self.op_fwd(save)
        u = u or TimeFunction(name='u', grid=self.model.grid,
                              save=self.geometry.nt if save else None,
                              time_order=2, space_order=self.space_order)
        kwargs.update(self.model.physical_params(**kwargs))
        summary = op.apply(src=src, rec=rec, u=u,
                           dt=kwargs.pop('dt', self.dt), **kwargs)
        return rec, u, summary

    def adjoint(self, rec, srca=None, v=None, **kwargs):
        op = self.op_adj()
        v = v or TimeFunction(name='v', grid=self.model.grid,
                              time_order=2, space_order=self.space_order)
        srca = srca if srca is not None else self.geometry.new_src(
            name='srca', src_type=None)
        kwargs.update(self.model.physical_params(**kwargs))
        summary = op.apply(rec=rec, src=srca, v=v,
                           dt=kwargs.pop('dt', self.dt), **kwargs)
        return srca, v, summary


def sa_setup(shape=(41, 41), spacing=(10., 10.), tn=250., space_order=8,
             npad=10, qmin=0.1, qmax=1000.0, f0=0.010, dtype=None,
             vp_value=1.5, b_value=1.0):
    """Build a self-adjoint iso solver (reference:
    self_adjoint/test_wavesolver_iso.py setup pattern)."""
    from .model import SeismicModel
    from .utils import setup_geometry
    dtype = dtype or np.float32
    v = np.full(shape, vp_value, dtype=dtype)
    b = np.full(shape, b_value, dtype=dtype)
    model = SeismicModel(origin=tuple(0. for _ in shape), spacing=spacing,
                         shape=shape, space_order=space_order, vp=v, b=b,
                         nbl=npad, dtype=dtype, bcs="damp")
    # replace the damping field with the w/Q attenuation field
    w = 2.0 * np.pi * f0
    wOverQ = Function(name='wOverQ', grid=model.grid,
                      space_order=space_order)
    setup_w_over_q(wOverQ, w, qmin, qmax, npad)
    model.damp = wOverQ
    geometry = setup_geometry(model, tn, f0=f0)
    return SaIsoWaveSolver(model, geometry, space_order=space_order)
