"""Viscoelastic (SLS) wave propagation on a staggered grid.

Reference parity: examples/seismic/viscoelastic/operators.py — velocity/
stress/memory-variable system with SLS relaxation times
(t_s, t_ep, t_es from qp/qs), elastic src/rec terms, mask damping; and the
'layers-viscoelastic' preset (preset_models.py:165).

On the card each dense equation runs in K1 (kernels/stencil.py): CIRE's
stars of one or two velocity components take the streaming design; the
velocity, memory-variable and stress updates and the hoisted relaxation
factors take the point design (more than two staged groups, or reads off
the axes).
"""

import numpy as np
import sympy as sp

from ...types import Eq, TimeFunction
from ...types.tensor import VectorTimeFunction, TensorTimeFunction
from ...operator import Operator
from ...operations.solve import solve
from ...finite_differences.operators import div, grad, diag
from ...utils import memoized_meth
from .utils import solver_spans
from .elastic import src_rec

__all__ = ['ViscoelasticForwardOperator', 'ViscoelasticWaveSolver',
           'viscoelastic_setup']


def ViscoelasticForwardOperator(model, geometry, space_order=4, save=False,
                                **kwargs):
    """Reference: viscoelastic ForwardOperator (operators.py:9)."""
    l, qp, mu, qs, b, damp = (model.lam, model.qp, model.mu, model.qs,
                              model.b, model.damp)
    f0 = geometry.f0
    t_s = (sp.sqrt(1. + 1. / qp ** 2) - 1. / qp) / f0
    t_ep = 1. / (f0 ** 2 * t_s)
    t_es = (1. + f0 * qs * t_s) / (f0 * qs - f0 ** 2 * t_s)

    save_t = geometry.nt if save else None
    v = VectorTimeFunction(name="v", grid=model.grid, save=save_t,
                           time_order=1, space_order=space_order)
    tau = TensorTimeFunction(name='t', grid=model.grid, save=save_t,
                             space_order=space_order, time_order=1)
    r = TensorTimeFunction(name='r', grid=model.grid, save=save_t,
                           space_order=space_order, time_order=1)

    pde_v = v.dt - b * div(tau)
    u_v = Eq(v.forward, damp * solve(pde_v, v.forward))

    e = grad(v.forward) + grad(v.forward).transpose(inner=False)

    pde_tau = tau.dt - r.forward - l * t_ep / t_s * diag(div(v.forward)) - \
        mu * t_es / t_s * e
    u_t = Eq(tau.forward, damp * solve(pde_tau, tau.forward))

    pde_r = r.dt + 1 / t_s * (r + l * (t_ep / t_s - 1) *
                              diag(div(v.forward)) +
                              mu * (t_es / t_s - 1) * e)
    u_r = Eq(r.forward, damp * solve(pde_r, r.forward))

    srcrec, rec1, rec2 = src_rec(v, tau, model, geometry)
    op = Operator([u_v, u_r, u_t] + srcrec, subs=model.spacing_map,
                  name='ViscoIsoElasticForward', **kwargs)
    op._fields = (v, tau, r, rec1, rec2)
    return op


@solver_spans
class ViscoelasticWaveSolver:
    """Reference: viscoelastic/wavesolver.py."""

    def __init__(self, model, geometry, space_order=4, **kwargs):
        self.model = model
        self.model._initialize_bcs(bcs="mask")
        # the viscoelastic system needs a smaller dt than the plain elastic
        # CFL bound (reference wavesolver.py:33-35)
        self.model.dt_scale = .9
        self.geometry = geometry
        self.space_order = space_order
        self._kwargs = kwargs

    @property
    def dt(self):
        return self.model.critical_dt

    @memoized_meth
    def op_fwd(self, save=None):
        return ViscoelasticForwardOperator(
            self.model, save=save, geometry=self.geometry,
            space_order=self.space_order, **self._kwargs)

    def forward(self, src=None, rec1=None, rec2=None, v=None, tau=None,
                r=None, model=None, save=None, **kwargs):
        src = src if src is not None else self.geometry.src
        op = self.op_fwd(save)
        save_t = self.geometry.nt if save else None
        v = v if v is not None else VectorTimeFunction(
            name='v', grid=self.model.grid, save=save_t,
            space_order=self.space_order, time_order=1)
        tau = tau if tau is not None else TensorTimeFunction(
            name='t', grid=self.model.grid, save=save_t,
            space_order=self.space_order, time_order=1)
        r = r if r is not None else TensorTimeFunction(
            name='r', grid=self.model.grid, save=save_t,
            space_order=self.space_order, time_order=1)
        rec1 = rec1 if rec1 is not None else self.geometry.new_rec(
            name='rec1')
        rec2 = rec2 if rec2 is not None else self.geometry.new_rec(
            name='rec2')
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        apply_kw = dict(src=src, rec1=rec1, rec2=rec2,
                        dt=kwargs.pop('dt', self.dt), **kwargs)
        for group in (v.components, tau.values(), r.values()):
            seen = set()
            for c in group:
                if c != 0 and id(c) not in seen:
                    seen.add(id(c))
                    apply_kw[c.name] = c
        summary = op.apply(**apply_kw)
        return rec1, rec2, v, tau, summary


def viscoelastic_setup(shape=(50, 50), spacing=(15., 15.), tn=500.,
                       space_order=4, nbl=10, ratio=3, dtype=None,
                       **kwargs):
    """Reference parity: 'layers-viscoelastic' preset
    (preset_models.py:165)."""
    from .model import SeismicModel
    from .utils import setup_geometry
    dtype = dtype or np.float32

    def layered(top, bottom):
        a = np.empty(shape, dtype=dtype)
        a[:] = top
        a[..., int(shape[-1] / ratio):] = bottom
        return a

    vp = layered(1.6, 2.2)
    qp = layered(40., 100.)
    vs = layered(0.4, 1.2)
    qs = layered(30., 70.)
    b = layered(1 / 1.3, 1 / 2.)

    origin = tuple(0. for _ in shape)
    model = SeismicModel(origin=origin, spacing=spacing, shape=shape,
                         space_order=space_order, vp=vp, qp=qp, vs=vs,
                         qs=qs, b=b, nbl=nbl, dtype=dtype, bcs="mask")
    geometry = setup_geometry(model, tn)
    return ViscoelasticWaveSolver(model, geometry,
                                  space_order=space_order, **kwargs)
