"""Sparse (off-grid) point functions: sources and receivers.

Reference parity: devito/types/sparse.py (AbstractSparseFunction:49,
SparseFunction:862 linear interpolation, SparseTimeFunction:1006 with
``.interpolate``/``.inject``, PrecomputedSparseFunction:1153,
MatrixSparseTimeFunction:1399, SincInterpolator via
``interpolation='sinc'``).

Interpolation lowers to a gather and injection to a scatter-add over
(corner x point) index tensors (compiler/executor.py _sparse_geometry).
The point coordinates live on the device next to the data; precomputed
and matrix functions carry their gridpoints and coefficient tables on the
host and move them to the device with the geometry.
"""

import numpy as np

from .dense import DiscreteFunction
from .dimension import DefaultDimension, Dimension

__all__ = ['SparseFunction', 'SparseTimeFunction',
           'PrecomputedSparseFunction', 'PrecomputedSparseTimeFunction',
           'MatrixSparseTimeFunction']


class _Coordinates:
    """Tiny wrapper so ``sf.coordinates.data`` matches the reference API."""

    def __init__(self, owner):
        self._owner = owner

    @property
    def data(self):
        return self._owner._coords_view()


class AbstractSparseFunction(DiscreteFunction):

    is_SparseFunction = True
    _sparse_position = -1

    @classmethod
    def __init_metadata__(cls, name=None, grid=None, npoint=None,
                          coordinates=None, nt=None, interpolation='linear',
                          r=2, dimensions=None, shape=None, dtype=None,
                          space_order=0, **kwargs):
        cls._grid = grid
        cls._npoint = npoint if npoint is not None else (
            len(coordinates) if coordinates is not None else 0)
        cls._dtype = np.dtype(dtype or (grid.dtype if grid is not None
                                        else np.float32))
        cls._space_order = space_order
        cls._staggered = None
        cls._interpolation = interpolation
        cls._r = r
        cls._halo = ()
        cls._p_dim = DefaultDimension(f"p_{name}",
                                      default_value=cls._npoint)
        cls._dimensions = cls._make_dimensions()
        cls._space_dimensions = ()
        # coordinates host/device buffers — physically real positions:
        # complex-valued functions keep real coordinates (the reference's
        # coordinates SubFunction is always grid-dtype real;
        # devito/types/sparse.py), and torch.floor in the interpolation
        # geometry rejects complex inputs
        cdtype = cls._dtype
        if np.issubdtype(cdtype, np.complexfloating):
            cdtype = np.dtype(np.float32 if cdtype == np.complex64
                              else np.float64)
        if coordinates is not None:
            coords = np.ascontiguousarray(
                np.asarray(coordinates, dtype=cdtype))
            nd = grid.dim if grid is not None else coords.shape[-1]
            if coords.ndim != 2 or coords.shape[-1] != nd:
                raise ValueError(
                    f"coordinates shape {coords.shape} does not match "
                    f"(npoint, {nd}) (reference: tests/"
                    f"test_interpolation.py test_wrong_coords)")
        else:
            nd = grid.dim if grid is not None else 0
            coords = np.zeros((cls._npoint, nd), dtype=cdtype)
        cls._coords_host = coords
        cls._coords_dev = None
        from ..parameters import torch_device
        cls._device = torch_device()
        cls._host_buf = None
        cls._dev_buf = None
        cls._coh = cls._HOST
        cls._initializer = None
        cls._is_parameter = False
        cls._constructor_kwargs = dict(
            name=name, grid=grid, npoint=npoint, nt=nt,
            interpolation=interpolation, r=r, dtype=cls._dtype,
            space_order=space_order)

    @classmethod
    def _make_dimensions(cls):
        return (cls._p_dim,)

    @property
    def npoint(self):
        return type(self)._npoint

    @property
    def interpolation(self):
        """Interpolation mode ('linear'/'sinc'/'precomputed') — public,
        as in the reference (types/sparse.py; tests/test_pickle.py
        asserts it round-trips)."""
        return type(self)._interpolation

    @property
    def shape(self):
        return (self.npoint,)

    shape_with_halo = shape
    shape_allocated = shape

    @property
    def coordinates(self):
        return _Coordinates(self)

    @coordinates.setter
    def coordinates(self, value):
        cls = type(self)
        cls._coords_host = np.ascontiguousarray(
            np.asarray(value, dtype=self.dtype))
        cls._coords_dev = None

    def _coords_view(self):
        cls = type(self)
        cls._coords_dev = None  # user may mutate through the view
        return cls._coords_host

    def _coords_device(self):
        import torch
        cls = type(self)
        if cls._coords_dev is None:
            cls._coords_dev = torch.from_numpy(cls._coords_host).to(
                device=cls._device, copy=True)
        return cls._coords_dev

    def _domain_view(self, buf):
        return buf

    def _leading_slices(self):
        return ()

    @property
    def interpolator(self):
        from ..operations.interpolators import (LinearInterpolator,
                                                SincInterpolator)
        mode = type(self)._interpolation
        if mode == 'linear':
            return LinearInterpolator()
        if mode == 'sinc':
            return SincInterpolator(type(self)._r)
        raise ValueError(f"Unknown interpolation {mode!r}")

    # -- the user-facing symbolic API -------------------------------------

    def interpolate(self, expr, u_t=None, p_t=None, increment=False,
                    implicit_dims=None):
        """Return a lazy Interpolation: this function's rows receive
        ``expr`` interpolated at the point coordinates (reference:
        SparseTimeFunction.interpolate, types/sparse.py:1089; ``u_t``
        shifts the sampled field's time index, ``p_t`` the recorded
        row)."""
        from ..operations.interpolators import Interpolation
        return Interpolation(self, expr, increment=increment,
                             u_t=u_t, p_t=p_t, implicit_dims=implicit_dims)

    def inject(self, field, expr, u_t=None, implicit_dims=None):
        """Return a lazy Injection: scatter ``expr`` (per point) into
        ``field`` with interpolation weights (reference:
        SparseTimeFunction.inject, types/sparse.py:1117)."""
        from ..operations.interpolators import Injection
        return Injection(self, field, expr, u_t=u_t,
                         implicit_dims=implicit_dims)


class SparseFunction(AbstractSparseFunction):
    """Time-independent point set: ``SparseFunction(name='s', grid=g,
    npoint=N, coordinates=...)``; data shape (npoint,)."""


class SparseTimeFunction(AbstractSparseFunction):
    """Time series at point locations: data shape (nt, npoint).

    ``SparseTimeFunction(name='rec', grid=g, npoint=N, nt=nt,
    coordinates=...)``.
    """

    is_SparseTimeFunction = True

    @classmethod
    def __init_metadata__(cls, nt=None, time_order=None, time_dim=None,
                          **kwargs):
        cls._nt = nt
        cls._time_order = time_order or 2
        # a ConditionalDimension time_dim subsamples the recording:
        # row k holds time k*factor (reference: types/sparse.py
        # SparseTimeFunction with a subsampled time_dim,
        # tests/test_dimension.py test_sparse_time_function:1729)
        cls._user_time_dim = time_dim
        super().__init_metadata__(nt=nt, **kwargs)

    @classmethod
    def _make_dimensions(cls):
        grid = cls._grid
        tdim = getattr(cls, '_user_time_dim', None)
        if tdim is None:
            tdim = grid.time_dim if grid is not None else Dimension('time')
        cls._time_dim_ = tdim
        return (tdim, cls._p_dim)

    @property
    def nt(self):
        return type(self)._nt

    @property
    def shape(self):
        return (self.nt, self.npoint)

    shape_with_halo = shape
    shape_allocated = shape

    @property
    def time_dim(self):
        return type(self)._time_dim_

    def _leading_slices(self):
        return (slice(None),)


class PrecomputedSparseFunction(AbstractSparseFunction):
    """Points with user-precomputed gridpoints + interpolation coefficients
    (reference: types/sparse.py:1153). ``gridpoints``: (P, ndim) ints, the
    minimum index of each point's stencil; ``interpolation_coeffs``: (P,
    ndim, r) weights of the points ``gridpoint + i``, i in [0, r)."""

    @classmethod
    def __init_metadata__(cls, gridpoints=None, interpolation_coeffs=None,
                          r=2, **kwargs):
        # 'interpolation' is implied by the type; drop an incoming value
        # (pickle reconstructs from _constructor_kwargs, which carries it)
        kwargs.pop('interpolation', None)
        super().__init_metadata__(r=r, interpolation='precomputed', **kwargs)
        cls._gridpoints = None if gridpoints is None else \
            np.asarray(gridpoints, dtype=np.int32)
        cls._interp_coeffs = None if interpolation_coeffs is None else \
            np.asarray(interpolation_coeffs)
        cls._constructor_kwargs.update(
            gridpoints=cls._gridpoints,
            interpolation_coeffs=cls._interp_coeffs)

    @property
    def gridpoints(self):
        return type(self)._gridpoints

    @property
    def interpolation_coeffs(self):
        return type(self)._interp_coeffs

    @property
    def interpolator(self):
        from ..operations.interpolators import PrecomputedInterpolator
        return PrecomputedInterpolator(self)


class PrecomputedSparseTimeFunction(PrecomputedSparseFunction,
                                    SparseTimeFunction):
    pass


class _NamedArray(np.ndarray):
    """ndarray view exposing itself as ``.data`` -- reference API shape
    (``msf.gridpoints.data[:] = ...``, ``coeffs[d].data[:] = ...``) while
    staying a plain array for internal consumers."""

    @property
    def data(self):
        return self


class MatrixSparseTimeFunction(SparseTimeFunction):
    """Externally-defined interpolation with matrix-coupled data channels
    (reference: types/sparse.py:1399 -- nloc locations with explicit
    gridpoints + per-dim coefficients; a (nloc x npoint) matrix couples the
    npoint data channels to the physical locations, supporting dipole-like
    multi-location sources without duplicating sample data).

    ``matrix``: scipy.sparse or ndarray, shape (nloc, npoint);
    ``gridpoints``: (nloc, ndim) minimum indices; per-dim coefficients via
    ``interpolation_coefficients[dim]`` arrays of shape (nloc, r).
    """

    @classmethod
    def __init_metadata__(cls, matrix=None, r=2, gridpoints=None,
                          interpolation_coeffs=None, **kwargs):
        if hasattr(matrix, 'toarray'):
            matrix = matrix.toarray()
        cls._matrix = np.asarray(matrix) if matrix is not None else None
        cls._r_points = r
        cls._gridpoints = None if gridpoints is None else \
            np.asarray(gridpoints, dtype=np.int32)
        cls._interp_coeffs = interpolation_coeffs
        # reference semantics: the data channels are the matrix columns
        kwargs.setdefault('npoint', cls._matrix.shape[1]
                          if cls._matrix is not None else 0)
        super().__init_metadata__(r=r, **kwargs)
        cls._constructor_kwargs.update(
            matrix=cls._matrix, gridpoints=cls._gridpoints,
            interpolation_coeffs=cls._interp_coeffs)

    @property
    def matrix(self):
        return type(self)._matrix

    @property
    def nloc(self):
        return type(self)._matrix.shape[0]

    @property
    def gridpoints(self):
        cls = type(self)
        if cls._gridpoints is None:
            cls._gridpoints = np.zeros((self.nloc, self.grid.dim),
                                       dtype=np.int32)
        return cls._gridpoints.view(_NamedArray)

    @gridpoints.setter
    def gridpoints(self, value):
        type(self)._gridpoints = np.asarray(value, dtype=np.int32)

    @property
    def interpolation_coefficients(self):
        cls = type(self)
        if cls._interp_coeffs is None:
            cls._interp_coeffs = {
                d: np.zeros((self.nloc, cls._r_points),
                            dtype=self.dtype)
                for d in self.grid.dimensions}
        return {d: v.view(_NamedArray) if isinstance(v, np.ndarray) else v
                for d, v in cls._interp_coeffs.items()}

    @property
    def interpolator(self):
        from ..operations.interpolators import MatrixInterpolator
        return MatrixInterpolator(self)

    def manual_scatter(self, *args, **kwargs):
        """API parity no-op, as devito_tpu's: the data lives whole on one
        device."""

    def manual_gather(self, *args, **kwargs):
        """API parity no-op."""
