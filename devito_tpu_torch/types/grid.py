"""Grid and SubDomain.

Reference parity: devito/types/grid.py (Grid:72, SubDomain:566, Interior,
SubDomainSet:783). The Grid owns the Cartesian domain (shape, extent,
origin, spacing symbols) and the time/stepping dimensions. ``topology=``
(or ``comm=``) decomposes it over a mesh of shards: its ``distributor``
(parallel/distributor.py).
"""

import numpy as np
import sympy

from .dimension import (SpaceDimension, TimeDimension, SteppingDimension,
                        SubDimension)
from ..utils import as_tuple
from ..parameters import configuration, torch_device

__all__ = ['Grid', 'SubDomain', 'SubDomainSet', 'Border', 'Interior', 'Domain']

_DEFAULT_DIM_NAMES = ['x', 'y', 'z']


class Grid:
    """A Cartesian grid: ``Grid(shape=(nx, ny), extent=..., origin=...)``.

    Parameters mirror the reference Grid. ``shape`` counts grid points;
    ``extent`` is the physical size (so spacing = extent/(shape-1));
    ``origin`` the physical coordinates of the first point.
   
    >>> grid = Grid(shape=(10, 10), extent=(9., 9.))
    >>> grid.shape
    (10, 10)
    >>> [d.name for d in grid.dimensions]
    ['x', 'y']
    >>> float(grid.spacing[0])
    1.0
    """

    def __init__(self, shape, extent=None, origin=None, dimensions=None,
                 time_dimension=None, dtype=None, subdomains=None,
                 comm=None, topology=None, distributor=None, spacing=None):
        self._shape = as_tuple(shape)
        ndim = len(self._shape)
        # reference API (tests/test_symbolics.py test_grid_inputs):
        # spacing= is an alternative to extent=; when both are given each
        # property reports its own argument verbatim (the reference keeps
        # them independent even if numerically inconsistent)
        self._spacing_override = as_tuple(spacing) \
            if spacing is not None else None
        if spacing is not None and extent is None:
            extent = tuple(h * max(s - 1, 1)
                           for h, s in zip(as_tuple(spacing), self._shape))
        # reference default: the UNIT box (extent 1.0 per dim, so
        # spacing = 1/(n-1)) — verified against the executed reference
        self._extent = as_tuple(extent) if extent is not None else \
            (1.,) * ndim
        self._origin = as_tuple(origin) if origin is not None else \
            (0.,) * ndim

        if dimensions is None:
            if ndim <= 3:
                names = _DEFAULT_DIM_NAMES[:ndim]
                # match reference: 2-D grids use (x, y); 3-D (x, y, z)
            else:
                names = [f"x{i}" for i in range(ndim)]
            dimensions = tuple(SpaceDimension(n) for n in names)
        self._dimensions = as_tuple(dimensions)

        if time_dimension is None:
            time_dimension = TimeDimension('time')
        self._time_dim = time_dimension
        self._stepping_dim = SteppingDimension('t', parent=self._time_dim)

        if dtype is None:
            dtype = np.dtype(configuration['dtype'])
        self._dtype = np.dtype(dtype)

        # raises here when configuration['device'] asks for CUDA and the
        # machine has none
        self._device = torch_device()

        # the mesh's Distributor (None: one device, unsharded)
        self._distributor = distributor
        if distributor is None and (comm is not None or
                                    topology is not None):
            from ..parallel.distributor import Distributor
            self._distributor = Distributor(self, topology=topology)

        self._subdomains = [Domain(grid=self), Interior(grid=self)]
        for sd in as_tuple(subdomains):
            sd.__subdomain_finalize__(self)
            self._subdomains.append(sd)

    @property
    def shape(self):
        return self._shape

    @property
    def distributor(self):
        return self._distributor

    @property
    def is_distributed(self):
        return self._distributor is not None

    @property
    def shape_local(self):
        if self._distributor is None:
            return self.shape
        return self._distributor.shape_local

    @property
    def dimensions(self):
        return self._dimensions

    @property
    def dim(self):
        return len(self._shape)

    @property
    def extent(self):
        return self._extent

    @property
    def origin(self):
        return self._origin

    @property
    def origin_map(self):
        return {sympy.Symbol(f"o_{d.name}"): v
                for d, v in zip(self.dimensions, self.origin)}

    @property
    def dtype(self):
        return self._dtype

    @property
    def time_dim(self):
        return self._time_dim

    @property
    def stepping_dim(self):
        return self._stepping_dim

    @property
    def spacing(self):
        if getattr(self, '_spacing_override', None) is not None:
            return self._spacing_override
        return tuple(e / max(s - 1, 1) for e, s in zip(self.extent, self.shape))

    @property
    def spacing_symbols(self):
        return tuple(d.spacing for d in self.dimensions)

    @property
    def spacing_map(self):
        """Map spacing symbols -> numeric values as grid-dtype scalars
        (reference: Grid.spacing_map dtype handling, tests/test_grid.py
        test_extent_dtypes; dt is absent — a runtime argument)."""
        cast = self._dtype.type
        return {s: cast(v) for s, v in zip(self.spacing_symbols,
                                           self.spacing)}

    @property
    def subdomains(self):
        return {sd.name: sd for sd in self._subdomains}

    @property
    def interior(self):
        return self.subdomains['interior']

    @property
    def device(self):
        """The ``torch.device`` of this grid's functions."""
        return self._device

    def __repr__(self):
        return (f"Grid[extent={self.extent}, shape={self.shape}, "
                f"dimensions={self.dimensions}]")

    # Convenience mirroring reference `Grid._arg_defaults`
    def _arg_defaults(self):
        args = {}
        for d, s in zip(self.dimensions, self.shape):
            args[d.min_name] = 0
            args[d.max_name] = s - 1
        return args


class SubDomain:
    """A rectangular sub-region of a Grid, defined per dimension as one of:
    - ``('left', k)``: first k points
    - ``('right', k)``: last k points
    - ``('middle', l, r)``: all but l leftmost and r rightmost points
    - ``x`` (the dimension itself): the whole dimension

    Subclass and override ``define`` (reference API), or use directly via
    ``SubDomain(name, {d: spec})``.
    """

    name = None

    def __init__(self, name=None, spec=None, grid=None):
        if name is not None:
            self.name = name
        self._spec = spec
        self._dimensions = None
        if grid is not None:
            self.__subdomain_finalize__(grid)

    def define(self, dimensions):
        """Return {dim: spec}. Override in subclasses (reference API)."""
        if self._spec is None:
            return {d: d for d in dimensions}
        byname = {(k.name if hasattr(k, 'name') else k): v
                  for k, v in self._spec.items()}
        return {d: byname.get(d.name, d) for d in dimensions}

    def __subdomain_finalize__(self, grid):
        self._grid = grid
        spec = self.define(grid.dimensions)
        # accept dimension names as keys alongside Dimension objects
        # (a string-keyed spec used to miss silently, leaving the whole
        # dimension — wrong shape with no error)
        byname = {(k.name if hasattr(k, 'name') else k): v
                  for k, v in spec.items()}
        dims = []
        for d in grid.dimensions:
            s = byname.get(d.name, d)
            # None or the dimension's name mean "the whole dimension",
            # alongside the reference's {d: d} form
            if s is d or s == d or s is None or \
                    (isinstance(s, str) and s == d.name):
                dims.append(d)
            else:
                side = s[0]
                nm = f"{d.name}_{self.name}_{side[:1]}"
                if side == 'left':
                    dims.append(SubDimension.left(nm, d, s[1]))
                elif side == 'right':
                    dims.append(SubDimension.right(nm, d, s[1]))
                elif side == 'middle':
                    dims.append(SubDimension.middle(nm, d, s[1], s[2]))
                else:
                    raise ValueError(f"Unknown subdomain side {side!r}")
        self._dimensions = tuple(dims)

    @property
    def grid(self):
        return self._grid

    @property
    def dimensions(self):
        return self._dimensions

    @property
    def dimension_map(self):
        return {d.root: d for d in self._dimensions}

    @property
    def shape(self):
        out = []
        for d, s in zip(self._dimensions, self._grid.shape):
            if d.is_Sub:
                start, stop = d.bounds(s)
                out.append(stop - start)
            else:
                out.append(s)
        return tuple(out)

    def bounds(self):
        """(start, stop) per dimension, in domain coordinates."""
        out = []
        for d, s in zip(self._dimensions, self._grid.shape):
            if d.is_Sub:
                out.append(d.bounds(s))
            else:
                out.append((0, s))
        return tuple(out)

    def __repr__(self):
        return f"SubDomain({self.name})"


class Domain(SubDomain):
    """The whole computational domain."""
    name = 'domain'

    def define(self, dimensions):
        return {d: d for d in dimensions}


class Interior(SubDomain):
    """The interior of the domain: everything but the outermost point layer
    (reference: grid.py Interior:1250)."""
    name = 'interior'

    def define(self, dimensions):
        return {d: ('middle', 1, 1) for d in dimensions}


class Border(SubDomain):
    """The boundary frame of the domain as a set of per-side slabs
    (reference: types/grid.py Border:948 — a MultiSubDomain over the
    border region with configurable thickness, sides and corner policy).

    ``thickness``: scalar, or one entry per dimension — each a scalar or
    a (left, right) pair. ``dims``: optional {dim: 'left'|'right'|'both'}
    restricting which sides carry a border. ``corners``: 'nooverlap'
    (default — slabs partition the frame; earlier dims own the corners),
    'overlap' (every slab spans the full extent of the other dims — the
    corners execute once per touching slab), or 'nocorners' (corner
    cells excluded entirely).
    """

    def __new__(cls, grid=None, thickness=1, dims=None,
                corners='nooverlap', name=None):
        if corners not in ('nooverlap', 'overlap', 'nocorners'):
            raise ValueError(f"Unknown corners policy {corners!r}")
        gdims = grid.dimensions
        nd = len(gdims)
        if isinstance(thickness, tuple):
            if len(thickness) != nd:
                raise ValueError(
                    f"thickness {thickness} does not match the grid's "
                    f"{nd} dimensions")
            ths = thickness
        else:
            ths = (thickness,) * nd
        pairs = []
        for t in ths:
            if isinstance(t, tuple):
                if len(t) != 2:
                    raise ValueError(
                        f"per-dimension thickness must be a scalar or a "
                        f"(left, right) pair, got {t}")
                pairs.append((int(t[0]), int(t[1])))
            else:
                pairs.append((int(t), int(t)))
        sides = {}
        byname = {(k.name if hasattr(k, 'name') else k): v
                  for k, v in (dims or {}).items()}
        for d in gdims:
            sides[d.name] = byname.get(d.name, 'both')

        shape = grid.shape
        regions = []  # per region: [(lt, rt), ...] thicknesses
        for i, d in enumerate(gdims):
            want = sides[d.name]
            for side in ('left', 'right'):
                if want not in (side, 'both'):
                    continue
                th = pairs[i][0 if side == 'left' else 1]
                if th <= 0:
                    continue
                region = []
                for j, dj in enumerate(gdims):
                    if j == i:
                        region.append((0, shape[i] - th) if side == 'left'
                                      else (shape[i] - th, 0))
                        continue
                    lj, rj = pairs[j]
                    wj = sides[dj.name]
                    lcut = lj if wj in ('left', 'both') else 0
                    rcut = rj if wj in ('right', 'both') else 0
                    if corners == 'overlap':
                        region.append((0, 0))
                    elif corners == 'nocorners':
                        # geometric corner cells excluded from every
                        # slab — by the full thickness, regardless of
                        # which sides carry a border (reference
                        # test_one_sided_border nocorners values)
                        region.append((lj, rj))
                    else:  # nooverlap: earlier dims own the corners
                        if j < i:
                            region.append((lcut, rcut))
                        else:
                            region.append((0, 0))
                regions.append(region)
        bounds = []
        for j in range(nd):
            bounds.append(np.array([r[j][0] for r in regions],
                                   dtype=np.int32))
            bounds.append(np.array([r[j][1] for r in regions],
                                   dtype=np.int32))
        return SubDomainSet(name=name or 'border', N=len(regions),
                            bounds=tuple(bounds), grid=grid)


class SubDomainSet(SubDomain):
    """N irregular rectangular regions, given by per-region bounds
    (reference: grid.py:783). Lowered to a mask / per-region slices.

    ``bounds``: tuple of 2*ndim arrays (lt_x, rt_x, lt_y, rt_y, ...), each of
    length N, giving thicknesses from each side per region.
    """

    def __init__(self, name=None, N=0, bounds=None, **kwargs):
        self._N = N
        self._bounds = bounds
        super().__init__(name=name, **kwargs)

    @property
    def n_domains(self):
        return self._N

    def region_bounds(self, grid):
        """Yield (start, stop) per dim for each region."""
        nd = grid.dim
        for i in range(self._N):
            region = []
            for j, s in enumerate(grid.shape):
                # scalar bounds broadcast to every region (reference:
                # test_subdomains.py test_multi_eq — bounds_ym = 1)
                lt = np.broadcast_to(np.asarray(self._bounds[2*j]),
                                     (self._N,))[i]
                rt = np.broadcast_to(np.asarray(self._bounds[2*j+1]),
                                     (self._N,))[i]
                region.append((int(lt), s - int(rt)))
            yield tuple(region)

    def __subdomain_finalize__(self, grid):
        self._grid = grid
        self._dimensions = grid.dimensions
