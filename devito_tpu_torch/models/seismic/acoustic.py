"""Acoustic wave propagators: Forward/Adjoint/Gradient/Born operators and
the AcousticWaveSolver.

Reference parity: examples/seismic/acoustic/operators.py (iso_stencil:71 —
``m u.dt2 - H - q + damp u.dt = 0`` with OT2/OT4 kernels:50-69) and
wavesolver.py:8 (memoized op_fwd/op_adj/op_grad/op_born, checkpointed
gradient). Same discretizations, injected/interpolated terms, and dt
conventions (OT4 runs at 1.73x the OT2 critical dt).

On the card each operator's stencil updates run in K1
(kernels/stencil.py): the adjoint's and the gradient's ``v.backward``
and Born's ``u.forward`` take the streaming design; Born's ``U.forward``
reads too many centre groups for the streaming tile and takes the point
design; the gradient's ``Inc`` runs in the torch translator, as the
increment ran in XLA, not in Pallas, on the TPU.
"""

import sympy

from ...types import Eq, Inc, Function, TimeFunction
from ...operator import Operator
from ...operations.solve import solve
from ...utils import memoized_meth
from .utils import solver_spans

__all__ = ['iso_stencil', 'laplacian', 'ForwardOperator', 'AdjointOperator',
           'GradientOperator', 'BornOperator', 'AcousticWaveSolver']


def laplacian(field, model, kernel):
    """Spatial discretization; OT4 adds the s^2/12 double-laplacian
    correction (reference: operators.py laplacian:50)."""
    if kernel not in ('OT2', 'OT4'):
        raise ValueError("Unrecognized kernel")
    s = model.grid.time_dim.spacing
    biharmonic = field.biharmonic(1 / model.m) if kernel == 'OT4' else 0
    return field.laplace + s ** 2 / 12 * biharmonic


def freesurface(model, eq):
    """Antisymmetric-mirror free surface at the top of the last dimension
    (reference: operators.py freesurface:5 — accesses below z=0 map to
    ``-u[|z|]``, plus ``u[z=0] = 0``).

    The reference lowers this with runtime ``INT(abs(z))`` indexing inside
    the fsdomain strip; here the strip is statically unrolled row by row so
    every equation stays fixed-offset slice algebra (TPU-friendly)."""
    from ...types.grid import SubDomain
    from ...types.basic import AbstractFunction, retrieve_functions
    from ...finite_differences.differentiable import evaluate_expr

    lhs, rhs = eq.lhs, eq.rhs
    grid = model.grid
    zdim = grid.dimensions[-1]
    nz = grid.shape[-1]
    so = lhs.function.space_order
    r = so  # unroll the full fsdomain thickness (reference strip = so)

    x0 = {d: lhs.function.stagger_offset(d)
          for d in lhs.function.dimensions if d.is_Space}
    ev = evaluate_expr(rhs, x0=x0)

    eqs = []
    for j in range(1, r):
        # mirror accesses that reach below z=0 in row j
        subsmap = {}
        for a in retrieve_functions(ev):
            zoff = sympy.simplify(a.args[-1] - zdim)
            if not zoff.is_number:
                continue
            k = int(zoff)
            if j + k < 0:
                knew = -(j + k) - j   # reflected row |j+k| as offset from j
                subsmap[a] = -a.shift(zdim, knew - k)
        row_rhs = ev.xreplace(subsmap) if subsmap else ev
        sd = SubDomain(name=f'__fsrow{j}',
                       spec={zdim: ('middle', j, nz - j - 1)}, grid=grid)
        eqs.append(Eq(lhs, row_rhs, subdomain=sd))
    # u = 0 on the free surface itself
    sd0 = SubDomain(name='__fsrow0', spec={zdim: ('middle', 0, nz - 1)},
                    grid=grid)
    eqs.append(Eq(lhs, 0, subdomain=sd0))
    return eqs


def iso_stencil(field, model, kernel, forward=True, q=0):
    """Time-update stencil of the isotropic acoustic wave equation
    ``m u.dt2 - H - q + damp udt = 0`` solved for the next timestep
    (reference: operators.py iso_stencil:71)."""
    unext = field.forward if forward else field.backward
    udt = field.dt if forward else field.dt.T
    lap = laplacian(field, model, kernel)
    eq_time = solve(model.m * field.dt2 - lap - q + model.damp * udt, unext)
    eqns = [Eq(unext, eq_time,
               subdomain=model.grid.subdomains['physdomain'])]
    if model.fs:
        eqns.extend(freesurface(model, Eq(unext, eq_time)))
    return eqns


def ForwardOperator(model, geometry, space_order=4, save=False,
                    kernel='OT2', **kwargs):
    """Forward modeling (reference: operators.py:110)."""
    m = model.m
    u = TimeFunction(name='u', grid=model.grid,
                     save=geometry.nt if save else None,
                     time_order=2, space_order=space_order)
    src = geometry.src
    rec = geometry.rec
    s = model.grid.stepping_dim.spacing

    eqn = iso_stencil(u, model, kernel)
    src_term = src.inject(field=u.forward, expr=src * s ** 2 / m)
    rec_term = rec.interpolate(expr=u)
    return Operator(eqn + [src_term, rec_term], subs=model.spacing_map,
                    name='Forward', **kwargs)


def AdjointOperator(model, geometry, space_order=4, kernel='OT2', **kwargs):
    """Adjoint modeling (reference: operators.py:153)."""
    m = model.m
    v = TimeFunction(name='v', grid=model.grid, save=None,
                     time_order=2, space_order=space_order)
    srca = geometry.new_src(name='srca', src_type=None)
    rec = geometry.rec
    s = model.grid.stepping_dim.spacing

    eqn = iso_stencil(v, model, kernel, forward=False)
    receivers = rec.inject(field=v.backward, expr=rec * s ** 2 / m)
    source_a = srca.interpolate(expr=v)
    return Operator(eqn + [receivers, source_a], subs=model.spacing_map,
                    name='Adjoint', **kwargs)


def GradientOperator(model, geometry, space_order=4, save=True,
                     kernel='OT2', **kwargs):
    """FWI gradient: backpropagate receivers, correlate with the saved
    forward wavefield (reference: operators.py:191, Inc(grad, -u*v.dt2))."""
    m = model.m
    grad = Function(name='grad', grid=model.grid)
    u = TimeFunction(name='u', grid=model.grid,
                     save=geometry.nt if save else None,
                     time_order=2, space_order=space_order)
    v = TimeFunction(name='v', grid=model.grid, save=None,
                     time_order=2, space_order=space_order)
    rec = geometry.rec
    s = model.grid.stepping_dim.spacing

    eqn = iso_stencil(v, model, kernel, forward=False)
    if kernel == 'OT2':
        gradient_update = Inc(grad, - u * v.dt2)
    else:
        gradient_update = Inc(grad, - u * v.dt2 - s ** 2 / 12.0 *
                              u.biharmonic(m ** (-2)) * v)
    receivers = rec.inject(field=v.backward, expr=rec * s ** 2 / m)
    return Operator(eqn + [receivers, gradient_update],
                    subs=model.spacing_map, name='Gradient', **kwargs)


def BornOperator(model, geometry, space_order=4, kernel='OT2', **kwargs):
    """Linearized Born modeling (reference: operators.py:235)."""
    m = model.m
    src, rec = geometry.src, geometry.rec
    u = TimeFunction(name='u', grid=model.grid, save=None,
                     time_order=2, space_order=space_order)
    U = TimeFunction(name='U', grid=model.grid, save=None,
                     time_order=2, space_order=space_order)
    dm = Function(name='dm', grid=model.grid, space_order=0)
    s = model.grid.stepping_dim.spacing

    eqn1 = iso_stencil(u, model, kernel)
    eqn2 = iso_stencil(U, model, kernel, q=-dm * u.dt2)
    source = src.inject(field=u.forward, expr=src * s ** 2 / m)
    receivers = rec.interpolate(expr=U)
    return Operator(eqn1 + [source] + eqn2 + [receivers],
                    subs=model.spacing_map, name='Born', **kwargs)


@solver_spans
class AcousticWaveSolver:
    """Seismic-inversion solver facade (reference: wavesolver.py:8)."""

    def __init__(self, model, geometry, kernel='OT2', space_order=4,
                 **kwargs):
        self.model = model
        self.model._initialize_bcs(bcs="damp")
        self.geometry = geometry
        self.space_order = space_order
        self.kernel = kernel
        self._kwargs = kwargs

    @property
    def dt(self):
        if self.kernel == 'OT4':
            return self.model.dtype.type(1.73 * self.model.critical_dt)
        return self.model.critical_dt

    @memoized_meth
    def op_fwd(self, save=None):
        return ForwardOperator(self.model, save=save,
                               geometry=self.geometry, kernel=self.kernel,
                               space_order=self.space_order, **self._kwargs)

    @memoized_meth
    def op_adj(self):
        return AdjointOperator(self.model, geometry=self.geometry,
                               kernel=self.kernel,
                               space_order=self.space_order, **self._kwargs)

    @memoized_meth
    def op_grad(self, save=True):
        return GradientOperator(self.model, save=save,
                                geometry=self.geometry, kernel=self.kernel,
                                space_order=self.space_order, **self._kwargs)

    @memoized_meth
    def op_born(self):
        return BornOperator(self.model, geometry=self.geometry,
                            kernel=self.kernel,
                            space_order=self.space_order, **self._kwargs)

    def forward(self, src=None, rec=None, u=None, model=None, save=None,
                **kwargs):
        src = src if src is not None else self.geometry.src
        rec = rec if rec is not None else self.geometry.rec
        u = u or TimeFunction(name='u', grid=self.model.grid,
                              save=self.geometry.nt if save else None,
                              time_order=2, space_order=self.space_order)
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        summary = self.op_fwd(save).apply(src=src, rec=rec, u=u,
                                          dt=kwargs.pop('dt', self.dt),
                                          **kwargs)
        return rec, u, summary

    def adjoint(self, rec, srca=None, v=None, model=None, **kwargs):
        srca = srca if srca is not None else \
            self.geometry.new_src(name='srca', src_type=None)
        v = v or TimeFunction(name='v', grid=self.model.grid,
                              time_order=2, space_order=self.space_order)
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        summary = self.op_adj().apply(srca=srca, rec=rec, v=v,
                                      dt=kwargs.pop('dt', self.dt), **kwargs)
        return srca, v, summary

    def jacobian_adjoint(self, rec, u, src=None, v=None, grad=None,
                         model=None, checkpointing=False, **kwargs):
        dt = kwargs.pop('dt', self.dt)
        grad = grad or Function(name='grad', grid=self.model.grid)
        v = v or TimeFunction(name='v', grid=self.model.grid,
                              time_order=2, space_order=self.space_order)
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        if checkpointing:
            # reference: wavesolver.py checkpointed-gradient path via
            # Revolver; here the native sqrt store/recompute schedule
            from ...checkpointing import (CheckpointOperator,
                                          DevitoCheckpoint, Revolver)
            u_ck = TimeFunction(name='u', grid=self.model.grid,
                                time_order=2,
                                space_order=self.space_order)
            cp = DevitoCheckpoint([u_ck])
            nt = self.geometry.nt
            tm, tM = 1, nt - 2
            wrap_fw = CheckpointOperator(
                self.op_fwd(save=False),
                src=src if src is not None else self.geometry.src,
                u=u_ck, dt=dt, **kwargs)
            wrap_rev = CheckpointOperator(
                self.op_grad(save=False), u=u_ck, v=v, rec=rec,
                grad=grad, dt=dt, **kwargs)
            wrp = Revolver(cp, wrap_fw, wrap_rev, None, tM - tm + 1,
                           t_min=tm)
            wrp.apply_forward()
            wrp.apply_reverse()
            return grad, None
        summary = self.op_grad().apply(rec=rec, grad=grad, v=v, u=u, dt=dt,
                                       **kwargs)
        return grad, summary

    def jacobian(self, dmin, src=None, rec=None, u=None, U=None, model=None,
                 **kwargs):
        src = src if src is not None else self.geometry.src
        rec = rec if rec is not None else self.geometry.rec
        u = u or TimeFunction(name='u', grid=self.model.grid,
                              time_order=2, space_order=self.space_order)
        U = U or TimeFunction(name='U', grid=self.model.grid,
                              time_order=2, space_order=self.space_order)
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        summary = self.op_born().apply(dm=dmin, u=u, U=U, src=src, rec=rec,
                                       dt=kwargs.pop('dt', self.dt),
                                       **kwargs)
        return rec, u, U, summary

    born = jacobian
    gradient = jacobian_adjoint
