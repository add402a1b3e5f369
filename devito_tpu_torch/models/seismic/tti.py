"""TTI (tilted transverse isotropy) anisotropic propagator, centered kernel.

Reference parity: examples/seismic/tti/operators.py (trig_func:42,
Gzz_centered:65, Gzz_centered_2d, Gh_centered, kernel_centered:170,
Forward/Adjoint operators:415-515) and wavesolver.py AnisotropicWaveSolver.
Same rotated-Laplacian construction (Zhang et al. 2011 self-adjoint form):
first derivatives at +h/2, composed back at -h/2.

On the card each dense equation of these operators runs in K1
(kernels/stencil.py). Under the default opt, CIRE (ir/cire.py) computes
the nested rotated derivatives into temporaries over halo-extended
regions, and the hoisting pass (ir/optimize.py) computes the invariant
factors into prologue temporaries; the centered kernel's updates read off
the axes (rotated derivatives), so all of them take the point design. The
gradient's ``Inc`` runs in the torch translator.
"""

import numpy as np
import sympy
from sympy import Rational

from ...finite_differences.elementary import cos, sin, sqrt

from ...types import Eq, TimeFunction
from ...operator import Operator
from ...operations.solve import solve
from ...finite_differences.derivative import Derivative
from ...utils import memoized_meth
from .utils import solver_spans

__all__ = ['kernel_centered', 'TTIForwardOperator', 'TTIAdjointOperator',
           'AnisotropicWaveSolver', 'tti_setup']


def trig_func(model):
    theta = getattr(model, 'theta', 0)
    costheta, sintheta = cos(theta), sin(theta)
    if model.dim == 3:
        phi = getattr(model, 'phi', 0)
        return costheta, sintheta, cos(phi), sin(phi)
    return costheta, sintheta


def _half(b, d, sign=+1):
    """Sample a (node) parameter at d +/- h/2 via 2-point interpolation
    (reference: `_subs(b, x, x+dx)` + off-grid evaluation)."""
    if not hasattr(b, 'is_DiscreteFunction') or not b.is_DiscreteFunction:
        return b
    return Derivative(b, (d, 0), fd_order=2,
                      x0={d: Rational(sign, 2)})


def rotation_rows(model):
    """Rows of the TTI rotation matrix: unit vectors of the rotated frame
    expressed in grid coordinates, horizontal rows first, symmetry axis
    (z') last. 2-D: tilt theta only; 3-D: tilt theta + azimuth phi."""
    if model.dim == 3:
        ct, st, cp, sp = trig_func(model)
        return [(ct * cp, ct * sp, -st),   # x'
                (-sp, cp, 0),              # y'
                (st * cp, st * sp, ct)]    # z'
    ct, st = trig_func(model)
    return [(ct, -st),                     # x'
            (st, ct)]                      # z'


def rotated_dir_derivative(model, field, row, side=None, weight=None,
                           fd_order=None, product=False):
    """Directional first derivative of ``field`` along a rotated-frame
    unit vector ``row``: sum_d c_d * D_d[field], with optional half-point
    evaluation (``side``=+1/-1 shifts x0 by +/- h/2, the Zhang et al.
    self-adjoint construction) and per-term ``weight(d)`` factors.
    ``product=True`` differentiates the product (c_d * field) instead —
    the adjoint (transpose) form used by backward kernels."""
    dims = model.space_dimensions
    out = 0
    for d, c in zip(dims, row):
        if c == 0:
            continue
        kw = {}
        if fd_order is not None:
            kw['fd_order'] = fd_order
        if side is not None:
            kw['x0'] = {d: d + Rational(side, 2) * d.spacing}
        w = weight(d) if weight is not None else 1
        if product:
            out += Derivative(w * c * field, d, **kw)
        else:
            out += w * c * Derivative(field, d, **kw)
    return out


def Gzz_centered(model, field):
    """Rotated second derivative along the symmetry axis,
    G_z'z' = D_z'^T ( b(+h/2) D_z' field ), first derivatives evaluated at
    +h/2 and composed back at -h/2 (Zhang et al. 2011 self-adjoint form;
    reference: examples/seismic/tti/operators.py Gzz_centered:65)."""
    b = getattr(model, 'b', 1)
    order1 = field.space_order // 2
    zrow = rotation_rows(model)[-1]
    Gz = rotated_dir_derivative(model, field, zrow, side=+1,
                                weight=lambda d: _half(b, d),
                                fd_order=order1)
    return rotated_dir_derivative(model, Gz, zrow, side=-1,
                                  fd_order=order1, product=True)


# retained alias (reference exposes a 2-D variant by name)
def Gzz_centered_2d(model, field):
    return Gzz_centered(model, field)


def Gh_centered(model, field):
    """Gxx+Gyy = (rotation-invariant) laplacian - Gzz."""
    Gzz = Gzz_centered(model, field) if model.dim == 3 else \
        Gzz_centered_2d(model, field)
    b = getattr(model, 'b', None)
    if b is not None and getattr(b, 'is_DiscreteFunction', False):
        # density-weighted rotation-invariant laplacian:
        # sum_d D_{-h/2}( b(+h/2) * D_{+h/2} field )
        so = field.space_order // 2
        lap = 0
        for d in model.space_dimensions:
            inner = _half(b, d) * Derivative(field, d, fd_order=so,
                                             x0={d: Rational(1, 2)})
            lap += Derivative(inner, d, fd_order=so,
                              x0={d: Rational(-1, 2)})
    else:
        lap = field.laplace
    return lap - Gzz


def second_order_stencil(model, u, v, H0, Hz, qu=0, qv=0, forward=True):
    """m u.dt2 = H0 - damp u.dt ; m v.dt2 = Hz - damp v.dt (reference:
    tti/operators.py:12)."""
    m, damp = model.m, model.damp
    unext = u.forward if forward else u.backward
    vnext = v.forward if forward else v.backward
    udt = u.dt if forward else u.dt.T
    vdt = v.dt if forward else v.dt.T

    stencilp = solve(m * u.dt2 - H0 - qu + damp * udt, unext)
    stencilr = solve(m * v.dt2 - Hz - qv + damp * vdt, vnext)
    phys = model.grid.subdomains['physdomain']
    return [Eq(unext, stencilp, subdomain=phys),
            Eq(vnext, stencilr, subdomain=phys)]


def kernel_centered(model, u, v, forward=True, qu=0, qv=0):
    """Reference: kernel_centered (tti/operators.py:170)."""
    delta, epsilon = model.delta, model.epsilon
    epsilon = 1 + 2 * epsilon
    delta = sqrt(1 + 2 * delta)
    Gzz = Gzz_centered_2d if model.dim == 2 else Gzz_centered

    if forward:
        Gxx = Gh_centered(model, u)
        Gz = Gzz(model, v)
        H0 = epsilon * Gxx + delta * Gz
        Hz = delta * Gxx + Gz
        return second_order_stencil(model, u, v, H0, Hz, qu, qv)
    else:
        H0 = Gh_centered(model, (epsilon * u + delta * v))
        Hz = Gzz(model, (delta * u + v))
        return second_order_stencil(model, u, v, H0, Hz, qu, qv,
                                    forward=forward)


def particle_velocities(model, space_order):
    """Edge-staggered particle-velocity fields for the staggered TTI
    kernel (reference: particle_velocity_fields, tti/operators.py:236)."""
    dims = model.space_dimensions
    names = ('vx', 'vy', 'vz')[:len(dims)] if model.dim == 3 \
        else ('vx', 'vz')
    return [TimeFunction(name=nm, grid=model.grid, staggered=d,
                         time_order=1, space_order=space_order)
            for nm, d in zip(names, dims)]


def kernel_staggered(model, u, v, forward=True, qu=0, qv=0):
    """First-order (velocity/pressure-pair) TTI system on a staggered
    grid (reference: kernel_staggered_2d/3d, tti/operators.py:263-413):

        d/dt w_i = -D_i' p        (w = rotated particle velocities)
        m du/dt  = -(1+2eps) sum_h D_h' w_h - sqrt(1+2delta) D_z' w_z
        m dv/dt  = -sqrt(1+2delta) sum_h D_h' w_h - D_z' w_z

    where D_i' are directional derivatives along the rotated frame
    (rotation_rows) and the horizontal rows are driven by ``u``, the
    symmetry axis by ``v``."""
    m, epsilon, delta = model.m, model.epsilon, model.delta
    epsilon = 1 + 2 * epsilon
    delta = sqrt(1 + 2 * delta)
    dampl = 1 - model.damp
    s = model.grid.stepping_dim.spacing

    rows = rotation_rows(model)
    vels = particle_velocities(model, u.space_order)
    # horizontal rows carry u's rotated gradient, the z' row carries v's
    drivers = [u] * (len(rows) - 1) + [v]

    eqs = []
    if forward:
        for w, row, f in zip(vels, rows, drivers):
            grad = rotated_dir_derivative(model, f, row)
            eqs.append(Eq(w.forward, dampl * w - dampl * s * grad))
        divs = [rotated_dir_derivative(model, w.forward, row)
                for w, row in zip(vels, rows)]
        dh, dz = sum(divs[:-1]), divs[-1]
        eqs.append(Eq(v.forward,
                      dampl * (v - s / m * (delta * dh + dz)) + s / m * qv))
        eqs.append(Eq(u.forward,
                      dampl * (u - s / m * (epsilon * dh + delta * dz))
                      + s / m * qu))
    else:
        # adjoint: product-form (transpose) directional derivatives of the
        # Thomsen-weighted field combinations
        a = epsilon * u + delta * v
        b = delta * u + v
        combos = [a] * (len(rows) - 1) + [b]
        for w, row, f in zip(vels, rows, combos):
            grad = rotated_dir_derivative(model, f, row, product=True)
            eqs.append(Eq(w.backward, dampl * w + dampl * s * grad))
        divs = [rotated_dir_derivative(model, w.backward, row,
                                       product=True)
                for w, row in zip(vels, rows)]
        dh, dz = sum(divs[:-1]), divs[-1]
        eqs.append(Eq(v.backward, dampl * (v + s / m * dz)))
        eqs.append(Eq(u.backward, dampl * (u + s / m * dh)))
    return eqs


def _tti_wavefields(model, geometry, space_order, kernel, names=('u', 'v'),
                    save=False):
    """u/v pair for a TTI kernel: 2nd-order in time at default stagger for
    'centered'; 1st-order at NODE for 'staggered'."""
    from ...types.basic import NODE
    to = 1 if kernel == 'staggered' else 2
    stagg = NODE if kernel == 'staggered' else None
    save_t = geometry.nt if save else None
    return [TimeFunction(name=nm, grid=model.grid, staggered=stagg,
                         save=save_t, time_order=to,
                         space_order=space_order) for nm in names]


def TTIForwardOperator(model, geometry, space_order=4, save=False,
                       kernel='centered', **kwargs):
    """Reference: tti ForwardOperator (operators.py:415)."""
    dt = model.grid.time_dim.spacing
    m = model.m
    u, v = _tti_wavefields(model, geometry, space_order, kernel, save=save)
    src = geometry.src
    rec = geometry.rec

    if kernel == 'staggered':
        stencils = kernel_staggered(model, u, v)
        expr = src * dt / m
    else:
        stencils = kernel_centered(model, u, v)
        expr = src * dt ** 2 / m
    stencils += [src.inject(field=(u.forward, v.forward), expr=expr)]
    stencils += [rec.interpolate(expr=u + v)]
    op = Operator(stencils, subs=model.spacing_map, name='ForwardTTI',
                  **kwargs)
    op._tti_fields = (u, v)
    return op


def TTIAdjointOperator(model, geometry, space_order=4, kernel='centered',
                       **kwargs):
    """Reference: tti AdjointOperator (operators.py:467)."""
    dt = model.grid.time_dim.spacing
    m = model.m
    p, r = _tti_wavefields(model, geometry, space_order, kernel,
                           names=('p', 'r'))
    srca = geometry.new_src(name='srca', src_type=None)
    rec = geometry.rec

    if kernel == 'staggered':
        stencils = kernel_staggered(model, p, r, forward=False)
        expr = rec * dt / m
    else:
        stencils = kernel_centered(model, p, r, forward=False)
        expr = rec * dt ** 2 / m
    stencils += [rec.inject(field=(p.backward, r.backward), expr=expr)]
    stencils += [srca.interpolate(expr=p + r)]
    op = Operator(stencils, subs=model.spacing_map, name='AdjointTTI',
                  **kwargs)
    op._tti_fields = (p, r, srca)
    return op


def TTIJacobianOperator(model, geometry, space_order=4, **kwargs):
    """Linearized Born in TTI media (reference: JacobianOperator,
    tti/operators.py:517)."""
    from ...types import Function
    dt = model.grid.stepping_dim.spacing
    m = model.m
    src, rec = geometry.src, geometry.rec
    u0 = TimeFunction(name='u0', grid=model.grid, time_order=2,
                      space_order=space_order)
    v0 = TimeFunction(name='v0', grid=model.grid, time_order=2,
                      space_order=space_order)
    du = TimeFunction(name='du', grid=model.grid, time_order=2,
                      space_order=space_order)
    dv = TimeFunction(name='dv', grid=model.grid, time_order=2,
                      space_order=space_order)
    dm = Function(name='dm', grid=model.grid, space_order=0)

    eqn1 = kernel_centered(model, u0, v0)
    eqn2 = kernel_centered(model, du, dv, qu=-dm * u0.dt2, qv=-dm * v0.dt2)
    src_term = src.inject(field=(u0.forward, v0.forward),
                          expr=src * dt ** 2 / m)
    rec_term = rec.interpolate(expr=du + dv)
    op = Operator(eqn1 + [src_term] + eqn2 + [rec_term],
                  subs=model.spacing_map, name='BornTTI', **kwargs)
    op._fields = (u0, v0, du, dv, dm)
    return op


def TTIJacobianAdjOperator(model, geometry, space_order=4, save=True,
                           **kwargs):
    """FWI gradient in TTI media (reference: JacobianAdjOperator,
    tti/operators.py:573)."""
    from ...types import Function, Inc
    dt = model.grid.stepping_dim.spacing
    m = model.m
    save_t = geometry.nt if save else None
    u0 = TimeFunction(name='u0', grid=model.grid, save=save_t,
                      time_order=2, space_order=space_order)
    v0 = TimeFunction(name='v0', grid=model.grid, save=save_t,
                      time_order=2, space_order=space_order)
    du = TimeFunction(name='du', grid=model.grid, time_order=2,
                      space_order=space_order)
    dv = TimeFunction(name='dv', grid=model.grid, time_order=2,
                      space_order=space_order)
    dm = Function(name='dm', grid=model.grid)
    rec = geometry.rec

    eqn = kernel_centered(model, du, dv, forward=False)
    dm_update = Inc(dm, -(u0 * du.dt2 + v0 * dv.dt2))
    rec_term = rec.inject(field=(du.backward, dv.backward),
                          expr=rec * dt ** 2 / m)
    op = Operator(eqn + [rec_term, dm_update], subs=model.spacing_map,
                  name='GradientTTI', **kwargs)
    op._fields = (u0, v0, du, dv, dm)
    return op


@solver_spans
class AnisotropicWaveSolver:
    """Reference: tti/wavesolver.py AnisotropicWaveSolver."""

    def __init__(self, model, geometry, space_order=4, kernel='centered',
                 **kwargs):
        self.model = model
        self.model._initialize_bcs(bcs="damp")
        self.geometry = geometry
        self.space_order = space_order
        self.kernel = kernel
        self._kwargs = kwargs

    @property
    def dt(self):
        return self.model.critical_dt

    @memoized_meth
    def op_fwd(self, save=None):
        return TTIForwardOperator(self.model, save=save,
                                  geometry=self.geometry,
                                  space_order=self.space_order,
                                  kernel=self.kernel, **self._kwargs)

    @memoized_meth
    def op_adj(self):
        return TTIAdjointOperator(self.model, geometry=self.geometry,
                                  space_order=self.space_order,
                                  kernel=self.kernel, **self._kwargs)

    def forward(self, src=None, rec=None, u=None, v=None, model=None,
                save=None, **kwargs):
        src = src if src is not None else self.geometry.src
        rec = rec if rec is not None else self.geometry.rec
        op = self.op_fwd(save)
        if u is None or v is None:
            un, vn = _tti_wavefields(self.model, self.geometry,
                                     self.space_order, self.kernel,
                                     save=save)
            u, v = u or un, v or vn
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        summary = op.apply(src=src, rec=rec, u=u, v=v,
                           dt=kwargs.pop('dt', self.dt), **kwargs)
        return rec, u, v, summary

    @memoized_meth
    def op_jac(self):
        return TTIJacobianOperator(self.model, geometry=self.geometry,
                                   space_order=self.space_order,
                                   **self._kwargs)

    @memoized_meth
    def op_jacadj(self, save=True):
        return TTIJacobianAdjOperator(self.model, geometry=self.geometry,
                                      space_order=self.space_order,
                                      save=save, **self._kwargs)

    def jacobian(self, dmin, src=None, rec=None, model=None, **kwargs):
        """Born modeling (reference: tti wavesolver.jacobian)."""
        src = src if src is not None else self.geometry.src
        rec = rec if rec is not None else self.geometry.rec
        op = self.op_jac()
        u0, v0, du, dv, dm0 = op._fields
        from ...types import Function
        dm = Function(name='dm', grid=self.model.grid, space_order=0)
        dm.data[:] = np.asarray(dmin if not hasattr(dmin, 'data')
                                else dmin.data)
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        for f in (u0, v0, du, dv):
            f.data[:] = 0
        op.apply(src=src, rec=rec, dm=dm, dt=kwargs.pop('dt', self.dt),
                 **kwargs)
        return rec, u0, v0, du, dv

    def jacobian_adjoint(self, rec, u0, v0, dm=None, model=None, **kwargs):
        """TTI FWI gradient (reference: tti wavesolver.jacobian_adjoint)."""
        from ...types import Function
        op = self.op_jacadj(True)
        dm = dm or Function(name='dm', grid=self.model.grid)
        du = TimeFunction(name='du', grid=self.model.grid, time_order=2,
                          space_order=self.space_order)
        dv = TimeFunction(name='dv', grid=self.model.grid, time_order=2,
                          space_order=self.space_order)
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        op.apply(rec=rec, u0=u0, v0=v0, du=du, dv=dv, dm=dm,
                 dt=kwargs.pop('dt', self.dt), **kwargs)
        return dm, None

    def adjoint(self, rec, srca=None, p=None, r=None, model=None, **kwargs):
        op = self.op_adj()
        srca = srca if srca is not None else self.geometry.new_src(
            name='srca', src_type=None)
        if p is None or r is None:
            pn, rn = _tti_wavefields(self.model, self.geometry,
                                     self.space_order, self.kernel,
                                     names=('p', 'r'))
            p, r = p or pn, r or rn
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        if self.kernel == 'staggered':
            # 1st-order system: the adjoint loop must run over exactly the
            # forward's iterations [0, nt-2] — any one-step window offset
            # shifts the whole adjoint map by one time sample (verified
            # exactly on the src->rec transfer matrix)
            kwargs.setdefault('time_m', 0)
            kwargs.setdefault('time_M', self.geometry.nt - 2)
        summary = op.apply(rec=rec, srca=srca, p=p, r=r,
                           dt=kwargs.pop('dt', self.dt), **kwargs)
        return srca, p, r, summary


def tti_setup(shape=(50, 50), spacing=(15., 15.), tn=500., space_order=4,
              nbl=10, nlayers=3, dtype=None, kernel='centered', **kwargs):
    """Reference parity: the 'layers-tti' preset (preset_models.py:210) +
    tti wavesolver setup."""
    from .model import SeismicModel
    from .utils import setup_geometry
    dtype = dtype or np.float32
    vp_top, vp_bottom = 1.5, 3.5
    v = np.empty(shape, dtype=dtype)
    v[:] = vp_top
    vp_i = np.linspace(vp_top, vp_bottom, nlayers)
    for i in range(1, nlayers):
        v[..., i * int(shape[-1] / nlayers):] = vp_i[i]
    epsilon = .1 * (v - vp_top)
    delta = .05 * (v - vp_top)
    theta = .5 * (v - vp_top)
    phi = .25 * (v - vp_top) if len(shape) > 2 else None

    origin = tuple(0. for _ in shape)
    model = SeismicModel(origin=origin, spacing=spacing, shape=shape,
                         space_order=space_order, vp=v, nbl=nbl,
                         dtype=dtype, epsilon=epsilon, delta=delta,
                         theta=theta, phi=phi, bcs="damp")
    geometry = setup_geometry(model, tn)
    return AnisotropicWaveSolver(model, geometry, space_order=space_order,
                                 kernel=kernel, **kwargs)
