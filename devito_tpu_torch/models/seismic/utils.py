"""Geometry setup helpers (reference: examples/seismic/utils.py:14-53
setup_geometry/setup_rec_coords and acoustic/acoustic_example.py
acoustic_setup:14)."""

from functools import wraps

import numpy as np

from ...utils import span
from .geometry import AcquisitionGeometry
from .model import demo_model

__all__ = ['setup_geometry', 'setup_rec_coords', 'acoustic_setup']

_default_radius = {'linear': 1, 'sinc': 4, 'precomputed': 2}

#: a solver's entry points that call ``Operator.apply``
SOLVER_ENTRIES = ('forward', 'adjoint', 'jacobian', 'jacobian_adjoint')


def solver_spans(cls):
    """Class decorator of a seismic solver: each of its ``SOLVER_ENTRIES``,
    and each alias of one (``born``, ``gradient``), runs in the span
    ``dtpu::solver.<entry>`` (utils/tools.py ``span``)."""
    def spanned(fn, name):
        @wraps(fn)
        def entry(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return entry

    wrapped = {id(cls.__dict__[name]): spanned(cls.__dict__[name],
                                               f'dtpu::solver.{name}')
               for name in SOLVER_ENTRIES if name in cls.__dict__}
    for attr, value in list(cls.__dict__.items()):
        if id(value) in wrapped:
            setattr(cls, attr, wrapped[id(value)])
    return cls


def setup_geometry(model, tn, f0=0.010, interpolation='linear', **kwargs):
    src_coordinates = np.empty((1, model.dim))
    if model.dim > 1:
        src_coordinates[0, :] = np.array(model.domain_size) * .5
        src_coordinates[0, -1] = model.origin[-1] + model.spacing[-1]
    else:
        src_coordinates[0, 0] = 2 * model.spacing[0]

    rec_coordinates = setup_rec_coords(model)
    r = kwargs.get('r', _default_radius[interpolation])
    return AcquisitionGeometry(model, rec_coordinates, src_coordinates,
                               t0=0.0, tn=tn, src_type='Ricker', f0=f0,
                               interpolation=interpolation, r=r)


def setup_rec_coords(model):
    nrecx = model.shape[0]
    recx = np.linspace(model.origin[0], model.domain_size[0], nrecx)
    if model.dim == 1:
        return recx.reshape((nrecx, 1))
    elif model.dim == 2:
        rec = np.empty((nrecx, 2))
        rec[:, 0] = recx
        rec[:, -1] = model.origin[-1] + 2 * model.spacing[-1]
        return rec
    else:
        nrecy = model.shape[1]
        recy = np.linspace(model.origin[1], model.domain_size[1], nrecy)
        rec = np.empty((nrecx * nrecy, 3))
        rec[:, 0] = np.repeat(recx, nrecy)
        rec[:, 1] = np.tile(recy, nrecx)
        rec[:, -1] = model.origin[-1] + 2 * model.spacing[-1]
        return rec


def acoustic_setup(shape=(50, 50, 50), spacing=(15., 15., 15.), tn=500.,
                   kernel='OT2', space_order=4, nbl=10,
                   preset='layers-isotropic', fs=False, **kwargs):
    from .acoustic import AcousticWaveSolver
    kwargs.pop('nlayers', None)
    kwargs.pop('time_order', None)
    model = demo_model(preset, space_order=space_order, shape=shape,
                       nbl=nbl, dtype=kwargs.pop('dtype', np.float32),
                       spacing=spacing, fs=fs,
                       **{k: v for k, v in kwargs.items()
                          if k in ('vp', 'vp_top', 'vp_bottom', 'origin')})
    geometry = setup_geometry(model, tn,
                              interpolation=kwargs.get('interpolation',
                                                       'linear'),
                              r=kwargs.get('r', 1))
    solver = AcousticWaveSolver(model, geometry, kernel=kernel,
                                space_order=space_order,
                                **{k: v for k, v in kwargs.items()
                                   if k in ('opt',)})
    return solver
