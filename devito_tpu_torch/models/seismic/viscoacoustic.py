"""Viscoacoustic propagators: SLS / Kelvin-Voigt / Maxwell rheologies,
1st- and 2nd-order formulations.

Reference parity: examples/seismic/viscoacoustic/operators.py:38-460 —
identical PDE systems (Blanch&Symes/Dutta&Schuster SLS, Bai 2nd-order SLS,
Ren Kelvin-Voigt, Deng-McMechan Maxwell), source/receiver terms, and
wavesolver.py ViscoacousticWaveSolver.

On the card each dense equation of the six kernels runs in K1
(kernels/stencil.py). The updates read three or more staged groups (or
only centres), and CIRE's temporaries are computed into the halo, so
they take the point design; hoisted prologue items that read qp and b
along one axis (the first-order sls adjoint's) take the streaming design.
"""

import numpy as np
import sympy as sp

from ...types import Eq, Function, TimeFunction, NODE
from ...types.tensor import VectorTimeFunction
from ...operator import Operator
from ...operations.solve import solve
from ...finite_differences.operators import div, grad
from ...utils import memoized_meth
from .utils import solver_spans

__all__ = ['ViscoForwardOperator', 'ViscoAdjointOperator',
           'ViscoacousticWaveSolver', 'viscoacoustic_setup']


def src_rec(p, model, geometry, forward=True):
    dt = model.grid.time_dim.spacing
    m = model.m
    src = geometry.src
    rec = geometry.rec
    scale = dt / m if p.time_order == 1 else dt ** 2 / m
    if forward:
        return [src.inject(field=p.forward, expr=src * scale),
                rec.interpolate(expr=p)]
    return [rec.inject(field=p.backward, expr=rec * scale),
            src.interpolate(expr=p)]


def _sls_params(model, f0):
    qp = model.qp
    t_s = (sp.sqrt(1. + 1. / qp ** 2) - 1. / qp) / f0
    t_ep = 1. / (f0 ** 2 * t_s)
    tt = (t_ep / t_s) - 1.
    return t_s, tt


def sls_1st_order(model, geometry, p, r=None, forward=True, save=False,
                  q=0, v=None, **kwargs):
    b, m, damp = model.b, model.m, model.damp
    f0 = geometry.f0
    save_t = geometry.nt if save else None
    t_s, tt = _sls_params(model, f0)
    rho = 1. / b

    r = r or TimeFunction(name="r", grid=model.grid, time_order=1,
                          space_order=p.space_order, save=save_t,
                          staggered=NODE)
    if forward:
        pde_v = v.dt + b * grad(p)
        u_v = Eq(v.forward, damp * solve(pde_v, v.forward))
        pde_r = r.dt + (1. / t_s) * (r + tt * rho * div(v.forward))
        u_r = Eq(r.forward, damp * solve(pde_r, r.forward))
        pde_p = m * p.dt + rho * (tt + 1.) * div(v.forward) + r.forward - q
        u_p = Eq(p.forward, damp * solve(pde_p, p.forward))
        return [u_v, u_r, u_p]
    else:
        pde_r = r.dt.T + (1. / t_s) * r + p
        u_r = Eq(r.backward, damp * solve(pde_r, r.backward))
        pde_v = -v.dtl - grad(rho * (1. + tt) * p) - \
            grad((1. / t_s) * rho * tt * r.backward)
        u_v = Eq(v.backward, damp * solve(pde_v, v.backward))
        pde_p = m * p.dt.T - div(b * v.backward)
        u_p = Eq(p.backward, damp * solve(pde_p, p.backward))
        return [u_r, u_v, u_p]


def sls_2nd_order(model, geometry, p, r=None, forward=True, save=False,
                  q=0, **kwargs):
    b, m, damp = model.b, model.m, model.damp
    f0 = geometry.f0
    save_t = geometry.nt if save else None
    t_s, tt = _sls_params(model, f0)
    rho = 1. / b

    r = r or TimeFunction(name="r", grid=model.grid, time_order=2,
                          space_order=p.space_order, save=save_t,
                          staggered=NODE)
    if forward:
        pde_r = r.dt - (tt / t_s) * rho * div(b * grad(p, shift=.5),
                                              shift=-.5) + (1. / t_s) * r
        u_r = Eq(r.forward, damp * solve(pde_r, r.forward))
        pde_p = m * p.dt2 - rho * (1. + tt) * div(b * grad(p, shift=.5),
                                                  shift=-.5) + \
            r.forward - q + (1 - damp) * p.dt
        u_p = Eq(p.forward, damp * solve(pde_p, p.forward))
        return [u_r, u_p]
    else:
        pde_r = r.dt.T + (tt / t_s) * p + (1. / t_s) * r
        u_r = Eq(r.backward, damp * solve(pde_r, r.backward))
        pde_p = m * p.dt2 - div(b * grad((1. + tt) * rho * p, shift=.5),
                                shift=-.5) - \
            div(b * grad(rho * r.backward, shift=.5), shift=-.5) + \
            (1 - damp) * p.dt.T
        u_p = Eq(p.backward, damp * solve(pde_p, p.backward))
        return [u_r, u_p]


def kv_1st_order(model, geometry, p, forward=True, v=None, **kwargs):
    b, m, damp, qp = model.b, model.m, model.damp, model.qp
    f0 = geometry.f0
    w0 = 2. * np.pi * f0
    rho = 1. / b
    tau = 1 / (w0 * qp)

    if forward:
        pde_v = v.dt + b * grad(p)
        u_v = Eq(v.forward, damp * solve(pde_v, v.forward))
        pde_p = m * p.dt + rho * div(v.forward) - \
            tau * rho * div(b * grad(p, shift=.5), shift=-.5)
        u_p = Eq(p.forward, damp * solve(pde_p, p.forward))
        return [u_v, u_p]
    else:
        pde_v = -v.dtl - grad(rho * p)
        u_v = Eq(v.backward, damp * solve(pde_v, v.backward))
        pde_p = m * p.dt.T - div(b * grad(rho * tau * p, shift=.5),
                                 shift=-.5) - div(b * v.backward)
        u_p = Eq(p.backward, damp * solve(pde_p, p.backward))
        return [u_v, u_p]


def kv_2nd_order(model, geometry, p, forward=True, **kwargs):
    s = model.grid.stepping_dim.spacing
    t0 = p.indices[0] - s / 2
    b, m, damp, qp = model.b, model.m, model.damp, model.qp
    f0 = geometry.f0
    w0 = 2. * np.pi * f0
    rho = 1. / b
    tau = 1 / (w0 * qp)

    if forward:
        pde_p = m * p.dt2 - rho * div(b * grad(p, shift=.5), shift=-.5) - \
            tau * rho * div(b * grad(p.dt(x0=t0), shift=.5), shift=-.5) + \
            (1 - damp) * p.dt
        return [Eq(p.forward, solve(pde_p, p.forward))]
    else:
        pde_p = m * p.dt2 - div(b * grad(rho * p, shift=.5), shift=-.5) - \
            div(b * grad(rho * tau * p.dt(x0=t0).T, shift=.5), shift=-.5) + \
            (1 - damp) * p.dt.T
        return [Eq(p.backward, solve(pde_p, p.backward))]


def maxwell_1st_order(model, geometry, p, forward=True, v=None, **kwargs):
    b, m, damp, qp = model.b, model.m, model.damp, model.qp
    f0 = geometry.f0
    w0 = 2. * np.pi * f0
    rho = 1. / b

    if forward:
        pde_v = v.dt + b * grad(p)
        u_v = Eq(v.forward, damp * solve(pde_v, v.forward))
        pde_p = m * p.dt + rho * div(v.forward) + (w0 / qp) * p
        u_p = Eq(p.forward, damp * solve(pde_p, p.forward))
        return [u_v, u_p]
    else:
        pde_v = -v.dtl - grad(rho * p)
        u_v = Eq(v.backward, damp * solve(pde_v, v.backward))
        pde_p = m * p.dt.T - div(b * v.backward) + (w0 / qp) * p
        u_p = Eq(p.backward, damp * solve(pde_p, p.backward))
        return [u_v, u_p]


def maxwell_2nd_order(model, geometry, p, forward=True, **kwargs):
    s = model.grid.stepping_dim.spacing
    t0 = p.indices[0] - s / 2
    b, m, damp, qp = model.b, model.m, model.damp, model.qp
    f0 = geometry.f0
    w0 = 2. * np.pi * f0
    rho = 1. / b

    if forward:
        pde_p = m * p.dt2 - rho * div(b * grad(p, shift=.5), shift=-.5) + \
            m * w0 / qp * p.dt(x0=t0) + (1 - damp) * p.dt
        return [Eq(p.forward, solve(pde_p, p.forward))]
    else:
        pde_p = m * p.dt2 + m * w0 / qp * p.dt(x0=t0).T + \
            (1 - damp) * p.dt.T - \
            div(b * grad(rho * p, shift=.5), shift=-.5)
        return [Eq(p.backward, solve(pde_p, p.backward))]


stencils = {('sls', 1): sls_1st_order, ('sls', 2): sls_2nd_order,
            ('kv', 1): kv_1st_order, ('kv', 2): kv_2nd_order,
            ('maxwell', 1): maxwell_1st_order,
            ('maxwell', 2): maxwell_2nd_order}


def ViscoForwardOperator(model, geometry, space_order=4, kernel='sls',
                         time_order=2, save=False, **kwargs):
    """Reference: viscoacoustic ForwardOperator (operators.py:482)."""
    save_t = geometry.nt if save else None
    extra = {}
    if time_order == 1:
        v = VectorTimeFunction(name="v", grid=model.grid,
                               time_order=time_order,
                               space_order=space_order, save=save_t)
        extra['v'] = v
    p = TimeFunction(name="p", grid=model.grid, time_order=time_order,
                     space_order=space_order, save=save_t, staggered=NODE)
    eqn = stencils[(kernel, time_order)](model, geometry, p, forward=True,
                                         save=save, **extra)
    terms = src_rec(p, model, geometry, forward=True)
    op = Operator(eqn + terms, subs=model.spacing_map,
                  name='ViscoIsoAcousticForward')
    op._fields = (p, extra.get('v'))
    return op


def ViscoAdjointOperator(model, geometry, space_order=4, kernel='sls',
                         time_order=2, **kwargs):
    """Reference: viscoacoustic AdjointOperator (operators.py:531)."""
    extra = {}
    if time_order == 1:
        va = VectorTimeFunction(name="va", grid=model.grid,
                                time_order=time_order,
                                space_order=space_order)
        extra['v'] = va
    pa = TimeFunction(name="pa", grid=model.grid, time_order=time_order,
                      space_order=space_order, staggered=NODE)
    eqn = stencils[(kernel, time_order)](model, geometry, pa, forward=False,
                                         **extra)
    terms = src_rec(pa, model, geometry, forward=False)
    op = Operator(eqn + terms, subs=model.spacing_map, name='ViscoAdjoint')
    op._fields = (pa, extra.get('v'))
    return op


@solver_spans
class ViscoacousticWaveSolver:
    """Reference: viscoacoustic/wavesolver.py ViscoacousticWaveSolver."""

    def __init__(self, model, geometry, space_order=4, kernel='sls',
                 time_order=2, **kwargs):
        self.model = model
        self.model._initialize_bcs(bcs="mask")
        self.geometry = geometry
        self.space_order = space_order
        self.kernel = kernel
        self.time_order = time_order
        self._kwargs = kwargs

    @property
    def dt(self):
        return self.model.critical_dt

    @memoized_meth
    def op_fwd(self, save=None):
        return ViscoForwardOperator(self.model, save=save,
                                    geometry=self.geometry,
                                    space_order=self.space_order,
                                    kernel=self.kernel,
                                    time_order=self.time_order,
                                    **self._kwargs)

    @memoized_meth
    def op_adj(self):
        return ViscoAdjointOperator(self.model, geometry=self.geometry,
                                    space_order=self.space_order,
                                    kernel=self.kernel,
                                    time_order=self.time_order,
                                    **self._kwargs)

    def _fresh_fields(self, names_vec, p_name, save_t=None):
        extra = {}
        if self.time_order == 1:
            v = VectorTimeFunction(name=names_vec, grid=self.model.grid,
                                   time_order=1,
                                   space_order=self.space_order,
                                   save=save_t)
            extra[names_vec] = v
        p = TimeFunction(name=p_name, grid=self.model.grid,
                         time_order=self.time_order,
                         space_order=self.space_order, save=save_t,
                         staggered=NODE)
        r = TimeFunction(name='r', grid=self.model.grid,
                         time_order=self.time_order,
                         space_order=self.space_order, save=save_t,
                         staggered=NODE)
        return p, r, extra

    def forward(self, src=None, rec=None, p=None, r=None, v=None,
                model=None, save=None, **kwargs):
        src = src if src is not None else self.geometry.src
        rec = rec if rec is not None else self.geometry.rec
        op = self.op_fwd(save)
        save_t = self.geometry.nt if save else None
        p_new, r_new, extra = self._fresh_fields('v', 'p', save_t)
        p = p or p_new
        r = r or r_new
        apply_kw = dict(src=src, rec=rec, p=p,
                        dt=kwargs.pop('dt', self.dt))
        if self.kernel == 'sls':
            apply_kw['r'] = r
        v = v if v is not None else extra.get('v')
        if v is not None:
            for c in v.components:
                apply_kw[c.name] = c
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        summary = op.apply(**apply_kw, **kwargs)
        return rec, p, v, summary

    def adjoint(self, rec, srca=None, pa=None, model=None, **kwargs):
        op = self.op_adj()
        srca = srca if srca is not None else self.geometry.new_src(
            name='srca', src_type=None)
        pa_new, r_new, extra = self._fresh_fields('va', 'pa', None)
        pa = pa or pa_new
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        if self.time_order == 1:
            # reference: wavesolver.py adjoint forces time_m=0 for the
            # 1st-order system
            kwargs.setdefault('time_m', 0)
        apply_kw = dict(rec=rec, src=srca, pa=pa,
                        dt=kwargs.pop('dt', self.dt))
        if self.kernel == 'sls':
            apply_kw['r'] = r_new
        va = extra.get('va')
        if va is not None:
            for c in va.components:
                apply_kw[c.name] = c
        summary = op.apply(**apply_kw, **kwargs)
        return srca, pa, summary


def viscoacoustic_setup(shape=(50, 50), spacing=(15., 15.), tn=500.,
                        space_order=4, nbl=10, nlayers=3, kernel='sls',
                        time_order=2, dtype=None, **kwargs):
    """Reference parity: 'layers-viscoacoustic' preset
    (preset_models.py:348 — vp profile + Li's empirical qp + Gardner b)."""
    from .model import SeismicModel
    from .utils import setup_geometry
    dtype = dtype or np.float32
    vp_top, vp_bottom = 1.5, 3.5
    v = np.empty(shape, dtype=dtype)
    v[:] = vp_top
    vp_i = np.linspace(vp_top, vp_bottom, nlayers)
    for i in range(1, nlayers):
        v[..., i * int(shape[-1] / nlayers):] = vp_i[i]
    qp = (3.516 * ((v * 1000.) ** 2.2) * 1e-6).astype(dtype)
    b = (1 / (0.31 * (1e3 * v) ** 0.25)).astype(dtype)

    origin = tuple(0. for _ in shape)
    model = SeismicModel(origin=origin, spacing=spacing, shape=shape,
                         space_order=space_order, vp=v, qp=qp, b=b,
                         nbl=nbl, dtype=dtype, bcs="mask")
    geometry = setup_geometry(model, tn)
    return ViscoacousticWaveSolver(model, geometry, space_order=space_order,
                                   kernel=kernel, time_order=time_order,
                                   **kwargs)
