"""Elastic wave propagation: 1st-order velocity-stress on a staggered grid.

Reference parity: examples/seismic/elastic/operators.py (velocity update
``v.dt = b div(tau)``, stress update
``tau.dt = lam diag(div(v+)) + mu (grad(v+) + grad(v+)^T)``, source into the
stress diagonal, receivers on tau_zz and div(v)) and wavesolver.py
(ElasticWaveSolver, bcs='mask' damping).

On the card each dense equation runs in K1 (kernels/stencil.py), and in
3-D at SO=4 every one takes the point design: the velocity updates (five
staged groups of radius 2), CIRE's div(v) temporary (three), the
normal-stress updates (each a line of one velocity component along one
axis, which the point design's caches hold), the shear-stress updates
and the hoisted harmonic means of mu (read off the axes). With 4096 or
more receiver corners, rec2's div(v) is first computed into a dense
temporary, ``rec2_itmp``, also on K1's point design. Each unit's point
struct is named after its target (``Point_v_x``, ``Point_tau_xy``,
``Point_temporary`` for CIRE's, the hoisted ones and ``rec2_itmp``), so a
device trace tells the fields' units apart.
"""

from ...types import Eq
from ...types.tensor import VectorTimeFunction, TensorTimeFunction
from ...operator import Operator
from ...operations.solve import solve
from ...finite_differences.operators import div, grad, diag
from ...utils import memoized_meth
from .utils import solver_spans

__all__ = ['ForwardElasticOperator', 'ElasticWaveSolver', 'elastic_setup']


def src_rec(v, tau, model, geometry):
    s = model.grid.time_dim.spacing
    src = geometry.src
    rec1 = geometry.new_rec(name="rec1")
    rec2 = geometry.new_rec(name="rec2")
    src_expr = src.inject(tau.forward.diagonal(), expr=src * s)
    rec_term1 = rec1.interpolate(expr=tau[-1, -1])
    rec_term2 = rec2.interpolate(expr=div(v))
    return [src_expr, rec_term1, rec_term2], rec1, rec2


def ForwardElasticOperator(model, geometry, space_order=4, save=False,
                           **kwargs):
    """Forward elastic operator (reference: elastic/operators.py:26)."""
    v = VectorTimeFunction(name='v', grid=model.grid,
                           save=geometry.nt if save else None,
                           space_order=space_order, time_order=1)
    tau = TensorTimeFunction(name='tau', grid=model.grid,
                             save=geometry.nt if save else None,
                             space_order=space_order, time_order=1)
    lam, mu, b = model.lam, model.mu, model.b

    eq_v = v.dt - b * div(tau)
    e = grad(v.forward) + grad(v.forward).transpose(inner=False)
    eq_tau = tau.dt - lam * diag(div(v.forward)) - mu * e

    u_v = Eq(v.forward, model.damp * solve(eq_v, v.forward))
    u_t = Eq(tau.forward, model.damp * solve(eq_tau, tau.forward))

    srcrec, rec1, rec2 = src_rec(v, tau, model, geometry)
    op = Operator([u_v, u_t] + srcrec, subs=model.spacing_map,
                  name="ForwardElastic", **kwargs)
    op._elastic_fields = (v, tau, rec1, rec2)
    return op


@solver_spans
class ElasticWaveSolver:
    """Reference: elastic/wavesolver.py ElasticWaveSolver."""

    def __init__(self, model, geometry, space_order=4, **kwargs):
        self.model = model
        self.model._initialize_bcs(bcs="mask")
        self.geometry = geometry
        self.space_order = space_order
        self._kwargs = kwargs

    @property
    def dt(self):
        return self.model.critical_dt

    @memoized_meth
    def op_fwd(self, save=None):
        return ForwardElasticOperator(self.model, save=save,
                                      geometry=self.geometry,
                                      space_order=self.space_order,
                                      **self._kwargs)

    def forward(self, src=None, rec1=None, rec2=None, v=None, tau=None,
                model=None, save=None, **kwargs):
        src = src if src is not None else self.geometry.src
        op = self.op_fwd(save)
        save_t = self.geometry.nt if save else None
        v = v if v is not None else VectorTimeFunction(
            name='v', grid=self.model.grid, save=save_t,
            space_order=self.space_order, time_order=1)
        tau = tau if tau is not None else TensorTimeFunction(
            name='tau', grid=self.model.grid, save=save_t,
            space_order=self.space_order, time_order=1)
        rec1 = rec1 if rec1 is not None else self.geometry.new_rec(
            name='rec1')
        rec2 = rec2 if rec2 is not None else self.geometry.new_rec(
            name='rec2')
        model = model or self.model
        kwargs.update(model.physical_params(**kwargs))
        apply_kw = dict(src=src, rec1=rec1, rec2=rec2,
                        dt=kwargs.pop('dt', self.dt), **kwargs)
        for c in v.components:
            apply_kw[c.name] = c
        seen = set()
        for c in tau.values():
            if c != 0 and id(c) not in seen:
                seen.add(id(c))
                apply_kw[c.name] = c
        summary = op.apply(**apply_kw)
        return rec1, rec2, v, tau, summary


def elastic_setup(shape=(50, 50), spacing=(15., 15.), tn=500.,
                  space_order=4, nbl=10, constant=False, nlayers=3,
                  dtype=None, **kwargs):
    """Reference parity: the 'layers-elastic' preset
    (examples/seismic/preset_models.py:142 — n-layer vp profile 1.5->3.5,
    vs = vp/2 with vs=0 in the water layer, Gardner's buoyancy)."""
    import numpy as np
    from .model import SeismicModel
    from .utils import setup_geometry
    dtype = dtype or np.float32
    vp_top, vp_bottom = 1.5, 3.5
    v = np.empty(shape, dtype=dtype)
    if constant:
        v[:] = 1.5
    else:
        v[:] = vp_top
        vp_i = np.linspace(vp_top, vp_bottom, nlayers)
        for i in range(1, nlayers):
            v[..., i * int(shape[-1] / nlayers):] = vp_i[i]
    vs = (0.5 * v).astype(dtype)
    b = (1 / (0.31 * (1e3 * v) ** 0.25)).astype(dtype)
    b[v < 1.51] = 1.0
    vs[v < 1.51] = 0.0
    origin = tuple(0. for _ in shape)
    model = SeismicModel(origin=origin, spacing=spacing, shape=shape,
                         space_order=space_order, vp=v, vs=vs, b=b,
                         nbl=nbl, dtype=dtype, bcs="mask")
    geometry = setup_geometry(model, tn)
    return ElasticWaveSolver(model, geometry, space_order=space_order,
                             **kwargs)
