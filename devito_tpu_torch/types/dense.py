"""Dense grid functions: Function and TimeFunction.

Reference parity: devito/types/dense.py (DiscreteFunction:43 with lazy
allocation and halo views, Function:975, TimeFunction:1345 with
``time_order``, ``save`` vs rolling buffer, ``.forward``/``.backward``).

Data plane: each function owns a coherent host (numpy) / device
(``torch.Tensor``) buffer pair, both in the plain halo'd layout
``shape_allocated`` (time axis first for a TimeFunction). ``.data`` hands
out a writable numpy *domain view* (host becomes authoritative);
Operators take the device tensor before running, update it in place and
mark the device authoritative. The device is fixed when the function is
built, from ``configuration['device']``.

The device tensor may be stored narrower than the function computes
(reference: devito_tpu/types/dense.py ``_storage_registry``,
``set_storage_dtype``): an Operator built with the ``storage-dtype`` opt
option sets it (bfloat16 or float16) before each apply and every other
Operator sets it back. The host buffer, and so ``.data``, stays in the
compute dtype; the narrow tensor holds the values rounded to nearest even.
Here the storage dtype is the function's own, not a registry's by name,
so that a later function of the same name starts in its compute dtype.

A ``save=nt`` TimeFunction may be host-streamed (Operator.
_apply_streamed): an apply holds only a window of its rows on the device
(``_device_window``, ``_absorb_window``), the rows passing through a
staging tensor, pinned on the card; the host copy is then authoritative.

On a distributed Grid the tensor stays whole (parallel/halo.py cuts the
shards from it for an apply and writes them back), and once an apply has
written it ``.data`` is the global-indexing ``Data`` view over it
(data.py) rather than a host copy. ``halo_state`` says what the halo holds
('zero', 'edge' after ``pad_outer_halo``, 'dirty' once ``data_with_halo``
was handed out), which decides whether a shard can rebuild it.
"""

import time as _time

import numpy as np
import sympy
import torch

from .basic import AbstractFunction, NODE
from .dimension import ConditionalDimension
from ..utils import as_tuple

__all__ = ['DiscreteFunction', 'Function', 'TimeFunction', 'Buffer']


class Buffer:
    """Explicit rolling-buffer size for ``TimeFunction(save=Buffer(k))``
    (reference: types/dense.py save=Buffer semantics — k modulo slots
    instead of the default time_order+1, no full history)."""

    def __init__(self, size):
        self.size = int(size)

    def __repr__(self):
        return f"Buffer({self.size})"


def torch_dtype(dtype):
    """The torch dtype of a numpy dtype (fp32 stays fp32, fp64 fp64)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


#: The narrow storage dtypes, by the names ``storage-dtype`` takes.
NARROW = {'bfloat16': torch.bfloat16, 'float16': torch.float16}


def storage_torch_dtype(dt):
    """The torch dtype of a storage dtype given as a name ('bfloat16',
    'float16', 'float32', ...), a numpy dtype or a torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str) and dt in NARROW:
        return NARROW[dt]
    return torch_dtype(dt)


def _stamp(on_card):
    """A CUDA event recorded on the current stream, or the host clock."""
    if not on_card:
        return _time.perf_counter()
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _seconds(a, b):
    """Seconds between two ``_stamp``s: host clock readings or CUDA
    events (synchronized already)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


def widen(arr, fn):
    """``arr``, a slice of ``fn``'s device tensor, in ``fn``'s compute
    dtype: a narrow-stored slice is converted, any other returned as it
    is."""
    if arr.dtype in (torch.bfloat16, torch.float16):
        want = torch_dtype(fn.dtype)
        if arr.dtype != want:
            return arr.to(want)
    return arr


class DiscreteFunction(AbstractFunction):
    """Common data machinery for grid-backed functions."""

    # data coherence states
    _HOST, _DEV, _BOTH = 'host', 'dev', 'both'

    # compiler-generated temporary (CIRE's derivative temporaries, the
    # interpolation's dense temporary): written every step, never
    # user-facing
    _compiler_temp = False

    @classmethod
    def __init_metadata__(cls, name=None, grid=None, shape=None,
                          dimensions=None, dtype=None, space_order=1,
                          staggered=None, padding=None, initializer=None,
                          allocator=None, parameter=False, avg_mode=None,
                          coefficients=None, **kwargs):
        # a Function may be defined on a SubDomain: its data covers only
        # that sub-region, its dimensions are the SubDimensions, and its
        # indices stay aligned with the GLOBAL grid indices via a
        # per-axis origin offset consumed by the compiler
        from .grid import SubDomain, SubDomainSet
        from ..parameters import torch_device
        cls._subdomain_fn = None
        cls._origin_offset = None
        if isinstance(grid, SubDomain):
            sd = grid
            if isinstance(sd, SubDomainSet):
                raise ValueError(
                    "Functions cannot be defined on a SubDomainSet")
            if sd.grid is None:
                raise ValueError(
                    f"SubDomain {sd.name} is not attached to a Grid")
            cls._subdomain_fn = sd
            grid = sd.grid
            cls._origin_offset = tuple(b[0] for b in sd.bounds())
        cls._grid = grid
        if cls._subdomain_fn is not None:
            space_dims = cls._subdomain_fn.dimensions
            space_shape = cls._subdomain_fn.shape
            dtype = dtype or grid.dtype
        elif grid is not None:
            space_dims = grid.dimensions
            space_shape = grid.shape
            dtype = dtype or grid.dtype
        else:
            space_dims = as_tuple(dimensions)
            space_shape = as_tuple(shape)
            dtype = dtype or np.float32
        if dimensions is not None:
            space_dims = as_tuple(dimensions)
        if shape is not None:
            space_shape = as_tuple(shape)
        if len(space_dims) != len(space_shape):
            raise ValueError(
                f"{len(space_dims)} dimensions given but shape has "
                f"{len(space_shape)} entries — pass a matching shape=")
        cls._space_dimensions = space_dims
        cls._space_shape = space_shape
        cls._dtype = np.dtype(dtype)
        cls._space_order = space_order
        cls._staggered = cls._normalize_staggered(staggered, space_dims)
        cls._initializer = initializer
        cls._is_parameter = parameter
        cls._coefficients = coefficients
        cls._avg_mode = avg_mode or 'arithmetic'
        cls._interp_order = 2
        # halo per space dim, each side
        cls._halo = tuple((space_order, space_order) for _ in space_dims)
        cls._dimensions = cls._make_dimensions()
        cls._constructor_kwargs = dict(
            name=name, grid=cls._subdomain_fn or grid, shape=shape,
            dimensions=dimensions,
            dtype=cls._dtype, space_order=space_order, staggered=staggered,
            parameter=parameter)
        # raises here, at construction, when CUDA is asked for and absent
        cls._device = torch_device()
        # data buffers (host numpy, device torch.Tensor, coherence state)
        cls._host_buf = None
        cls._dev_buf = None
        cls._coh = cls._HOST
        # the device tensor's dtype when narrower than the compute dtype
        cls._storage = None
        # what the halo holds: 'zero', 'edge' or 'dirty' (halo_state)
        cls._halo_state = 'zero'

    @staticmethod
    def _normalize_staggered(staggered, dims):
        if staggered is None or staggered == NODE:
            return None
        return staggered

    @classmethod
    def _make_dimensions(cls):
        return cls._space_dimensions

    # -- shapes -----------------------------------------------------------

    @property
    def time_dim(self):
        return getattr(type(self), '_time_dim_', None)

    @property
    def space_dimensions(self):
        return type(self)._space_dimensions

    @property
    def shape(self):
        return type(self)._space_shape

    @property
    def halo(self):
        return type(self)._halo

    @property
    def shape_with_halo(self):
        return tuple(n + l + r for n, (l, r)
                     in zip(self.shape, self.halo))

    def _allocated_space(self):
        """Allocated extent per space axis: halo'd, with the innermost
        axis rounded up to 128 and the next one to 8. This is the JAX
        package's single-device layout, kept so that state carries over
        one to one (utils.load_numpy_state); the rounded innermost extent
        also starts every row of the tensor on a 512-byte boundary."""
        from ..utils import round_up
        s = tuple(n + l + r for n, (l, r) in zip(type(self)._space_shape,
                                                 type(self)._halo))
        if not s:
            return s
        s = s[:-1] + (round_up(s[-1], 128),)
        if len(s) >= 2:
            s = s[:-2] + (round_up(s[-2], 8), s[-1])
        return s

    @property
    def shape_allocated(self):
        """Halo'd shape with the row padding of ``_allocated_space``."""
        return self._allocated_space()

    @property
    def origin_offset(self):
        """Global domain index of this function's first interior point
        per space axis: nonzero only for Functions defined on a SubDomain
        (iteration regions stay in GLOBAL coordinates; the compiler
        subtracts this offset when slicing the local buffer)."""
        oo = getattr(type(self), '_origin_offset', None)
        if oo is None:
            return (0,) * len(self.space_dimensions)
        return oo

    @property
    def subdomain(self):
        """The SubDomain this function is defined on (None for whole-grid
        functions)."""
        return getattr(type(self), '_subdomain_fn', None)

    @property
    def device(self):
        """The ``torch.device`` holding this function's tensor."""
        return type(self)._device

    @property
    def is_parameter(self):
        return type(self)._is_parameter

    @property
    def storage_dtype(self):
        """The device tensor's dtype: the compute dtype (a numpy dtype)
        unless an Operator's ``storage-dtype`` narrowed it, then
        ``np.float16`` or ``torch.bfloat16`` (numpy has no bfloat16)."""
        st = getattr(type(self), '_storage', None)
        if st is None:
            return self.dtype
        return np.dtype(np.float16) if st == torch.float16 else st

    def set_storage_dtype(self, dt):
        """Store the device tensor as ``dt`` (see ``storage_torch_dtype``;
        the compute dtype restores it). Device-authoritative data goes
        through the host first, so values survive a switch, rounded to the
        narrower of the two dtypes."""
        cls = type(self)
        want = storage_torch_dtype(dt)
        want = None if want == torch_dtype(self.dtype) else want
        if want == getattr(cls, '_storage', None):
            return
        if cls._coh == self._DEV and cls._dev_buf is not None:
            self._ensure_host()
        cls._dev_buf = None
        if cls._coh == self._BOTH:
            cls._coh = self._HOST
        cls._storage = want

    @property
    def symbolic_shape(self):
        return self.shape

    # -- data management --------------------------------------------------

    def _allocate(self):
        cls = type(self)
        if cls._host_buf is None:
            cls._host_buf = np.zeros(self.shape_allocated, dtype=self.dtype)
            # pristine: all-zero and never exposed to the user — the
            # device tensor is then created with torch.zeros on the device
            # instead of copying zeros from the host
            cls._pristine_zero = cls._initializer is None
            if cls._initializer is not None:
                view = self._domain_view(cls._host_buf)
                cls._initializer(view)
        return cls._host_buf

    def _domain_view(self, buf):
        slices = self._leading_slices() + tuple(
            slice(l, l + n) for n, (l, r) in zip(self.shape, self.halo))
        return buf[slices]

    def _leading_slices(self):
        return ()

    def _ensure_host(self):
        cls = type(self)
        self._allocate()
        if cls._coh == self._DEV:
            np.copyto(cls._host_buf, widen(cls._dev_buf, self).cpu().numpy())
        cls._coh = self._HOST  # user may write through the view
        cls._pristine_zero = False
        cls._dev_buf = None
        return cls._host_buf

    def _device_array(self):
        """The device ``torch.Tensor`` (layout ``shape_allocated``, in the
        storage dtype), pushing host data if needed. Operators update it in
        place."""
        cls = type(self)
        self._allocate()
        if cls._coh == self._HOST or cls._dev_buf is None:
            buf = cls._host_buf
            dt = getattr(cls, '_storage', None) or torch_dtype(buf.dtype)
            if getattr(cls, '_pristine_zero', False):
                cls._dev_buf = torch.zeros(buf.shape, dtype=dt,
                                           device=cls._device)
            else:
                # a copy even on the CPU: the host buffer must not alias
                # the tensor that operators update in place
                cls._dev_buf = torch.from_numpy(buf).to(
                    device=cls._device, dtype=dt, copy=True)
            cls._coh = self._BOTH
        return cls._dev_buf

    def _set_device_array(self, arr):
        """Adopt ``arr`` as the authoritative (device) buffer."""
        cls = type(self)
        cls._dev_buf = arr
        cls._coh = self._DEV

    # -- host streaming of save rows (Operator._apply_streamed) -------------

    def _staging(self, shape, dtype, split=None):
        """The function's staging tensor of ``shape`` and ``dtype`` on the
        host, pinned when the device is CUDA (a failed pinned allocation
        raises; nothing falls back to pageable copies), made at the first
        call and reused while the shape holds (``split`` gets the
        allocation's 'pin' seconds). Before it is handed out, the last
        copy from it to the device has completed."""
        cls = type(self)
        st = getattr(cls, '_stage', None)
        if st is None or tuple(st.shape) != tuple(shape) or \
                st.dtype != dtype:
            cls._stage = cls._stage_done = None
            tic = _time.perf_counter()
            st = cls._stage = torch.empty(
                shape, dtype=dtype, pin_memory=cls._device.type == 'cuda')
            if split is not None:
                split.append(('pin', tic, _time.perf_counter(),
                              st.numel() * st.element_size()))
        done = getattr(cls, '_stage_done', None)
        if done is not None:
            done.synchronize()
            cls._stage_done = None
        return st

    def _release_staging(self):
        """Drop the staging tensor (a streamed apply ends)."""
        type(self)._stage = type(self)._stage_done = None

    def _device_window(self, lo, hi, out=None, split=None):
        """The device tensor of save rows ``[lo, hi)`` in the storage
        dtype, rows outside ``[0, nt)`` zero (reference:
        devito_tpu/types/dense.py ``_device_window``): ``out`` (a window
        an earlier call returned) filled in place, else a new tensor.
        Device-authoritative data goes to the host first. The rows pass
        through the staging tensor (``_staging``): host rows to staging by
        torch's multi-threaded ``copy_``, staging to the device with
        ``non_blocking=True``. ``split`` (a list) gets ``(phase, start,
        end, bytes)`` of both copies: 'h2s' on the host clock, 's2d' as
        CUDA events on the card (and 'pin', a new staging tensor's)."""
        cls = type(self)
        host = self._ensure_host()
        dt = getattr(cls, '_storage', None) or torch_dtype(self.dtype)
        shape = (hi - lo,) + host.shape[1:]
        if out is None:
            out = torch.empty(shape, dtype=dt, device=cls._device)
        nt = self.shape[0]
        a0, a1 = max(lo, 0), min(hi, nt)
        on_card = cls._device.type == 'cuda'
        st = self._staging(shape, dt, split)
        tic = _time.perf_counter()
        if a1 > a0:
            st[a0 - lo:a1 - lo].copy_(torch.from_numpy(host[a0:a1]))
        st[:max(a0 - lo, 0)].zero_()
        st[max(a1 - lo, 0):].zero_()
        toc = _time.perf_counter()
        a = _stamp(on_card)
        out.copy_(st, non_blocking=True)
        b = _stamp(on_card)
        if on_card:
            cls._stage_done = b
        if split is not None:
            nbytes = st.numel() * st.element_size()
            split += [('h2s', tic, toc, nbytes), ('s2d', a, b, nbytes)]
        return out

    def _absorb_window(self, win, lo, split=None):
        """Write the window ``win`` of save rows back into the host rows
        from ``lo``, skipping rows outside ``[0, nt)``; the host becomes
        authoritative (reference: devito_tpu/types/dense.py
        ``_absorb_window``). Device to staging, a synchronize, then staging
        to the host rows, widened to the compute dtype; ``split`` gets
        'd2s' (CUDA events) and 's2h' (host clock)."""
        cls = type(self)
        host = self._allocate()
        nt = self.shape[0]
        a0, a1 = max(lo, 0), min(lo + win.shape[0], nt)
        if a1 > a0:
            on_card = cls._device.type == 'cuda'
            st = self._staging(tuple(win.shape), win.dtype, split)
            rows = slice(a0 - lo, a1 - lo)
            a = _stamp(on_card)
            st[rows].copy_(win[rows], non_blocking=True)
            b = _stamp(on_card)
            if on_card:
                b.synchronize()
            tic = _time.perf_counter()
            torch.from_numpy(host[a0:a1]).copy_(st[rows])
            toc = _time.perf_counter()
            if split is not None:
                nbytes = st[rows].numel() * st.element_size()
                split += [('d2s', a, b, nbytes), ('s2h', tic, toc, nbytes)]
        cls._coh = self._HOST
        cls._pristine_zero = False
        cls._dev_buf = None

    @property
    def data(self):
        """Writable numpy view over the domain region (host becomes
        authoritative); for a function of a distributed Grid whose device
        tensor is authoritative, the global-indexing ``Data`` view over it
        (devito_tpu: types/dense.py:495-511)."""
        cls = type(self)
        grid = cls._grid
        if cls._coh == self._DEV and cls._dev_buf is not None and \
                not self.is_SparseFunction and grid is not None and \
                grid.distributor is not None:
            from ..data import Data
            return Data(self)
        return self._domain_view(self._ensure_host())

    @property
    def data_with_halo(self):
        buf = self._ensure_host()
        # the user may write anything into the halo through this view: a
        # shard can no longer rebuild it from the exchange and edge rules
        # (parallel/halo.py explicit_halo_eligible)
        type(self)._halo_state = 'dirty'
        # trim the row padding
        sl = tuple(slice(0, n) for n in self.shape_with_halo)
        return buf[sl]

    @property
    def halo_state(self):
        """What the halo provably holds: 'zero' (never written), 'edge'
        (``pad_outer_halo``'s edge values) or 'dirty' (the user's, through
        ``data_with_halo``)."""
        return type(self)._halo_state

    def pad_outer_halo(self):
        """Edge-replicate the domain data into the outer halo ring
        (reference: initialize_function's pad_halo — so shifted reads of
        physical parameters near the boundary see edge values, not
        zeros)."""
        buf = self._ensure_host()
        if type(self)._halo_state == 'zero':
            type(self)._halo_state = 'edge'
        lead = len(self._leading_slices())
        for j, (n, (hl, hr)) in enumerate(zip(
                type(self)._space_shape, type(self)._halo)):
            ax = lead + j
            sl_all = [slice(None)] * buf.ndim
            if hl:
                src = list(sl_all)
                src[ax] = slice(hl, hl + 1)
                dst = list(sl_all)
                dst[ax] = slice(0, hl)
                buf[tuple(dst)] = buf[tuple(src)]
            if hr:
                src = list(sl_all)
                src[ax] = slice(hl + n - 1, hl + n)
                dst = list(sl_all)
                dst[ax] = slice(hl + n, hl + n + hr)
                buf[tuple(dst)] = buf[tuple(src)]

    # Read-only accessors (reference API)
    @property
    def data_ro_domain(self):
        v = self.data
        v = v.view()
        v.flags.writeable = False
        return v

    @property
    def data_ro_with_halo(self):
        v = self.data_with_halo.view()
        v.flags.writeable = False
        return v


class Function(DiscreteFunction):
    """A space-varying discrete function ``f(x, y[, z])``.

    ``Function(name='f', grid=grid, space_order=so)``.
    """

    is_Function = True

    @property
    def _time_size(self):
        return None

    def avg(self, dims=None):
        """Arithmetic average over the 2^n neighboring points toward the
        staggered cell (reference: Function.avg, used by staggered-grid
        physics for material parameters)."""
        dims = as_tuple(dims) if dims is not None else self.space_dimensions
        from ..finite_differences.differentiable import Add, Mul
        shifts = [self]
        for d in dims:
            shifts = [s.subs(d, d + r) for s in shifts for r in (0, 1)]
        return Mul(sympy.Rational(1, len(shifts)), Add(*shifts))


class TimeFunction(Function):
    """A time- and space-varying function ``u(t, x, y[, z])``.

    ``TimeFunction(name='u', grid=grid, time_order=2, space_order=so,
    save=None)``. With ``save=None`` a rolling buffer of ``time_order + 1``
    slots is used (reference: SteppingDimension modulo buffering); with
    ``save=N`` the full time history is stored.
    """

    is_TimeFunction = True

    @classmethod
    def __init_metadata__(cls, time_order=1, save=None, time_dim=None,
                          **kwargs):
        cls._time_order = time_order
        cls._save = save
        dims = kwargs.get('dimensions')
        if time_dim is None and dims:
            # a leading time/stepping dim in `dimensions=` becomes the
            # time dim; a PLAIN leading dimension also serves as the time
            # axis when `shape=` covers it
            dims = as_tuple(dims)
            lead = dims[0]
            sh = kwargs.get('shape')
            covers_time = sh is not None and \
                len(as_tuple(sh)) == len(dims)
            if getattr(lead, 'is_Time', False) or \
                    getattr(lead, 'is_Stepping', False) or covers_time:
                time_dim = lead
                kwargs['dimensions'] = dims[1:]
                if covers_time:
                    sh = as_tuple(sh)
                    if save is None and not getattr(lead, 'is_Stepping',
                                                    False):
                        cls._save = save = sh[0]
                    kwargs['shape'] = sh[1:]
        cls._user_time_dim = time_dim
        super().__init_metadata__(**kwargs)
        cls._constructor_kwargs.update(time_order=time_order, save=save,
                                       time_dim=time_dim)

    @classmethod
    def _make_dimensions(cls):
        grid = cls._grid
        full_save = cls._save is not None and not isinstance(cls._save,
                                                            Buffer)
        if cls._user_time_dim is not None:
            tdim = cls._user_time_dim
        elif full_save:
            tdim = grid.time_dim if grid is not None else None
        else:
            tdim = grid.stepping_dim if grid is not None else None
        if tdim is None:
            from .dimension import TimeDimension, SteppingDimension
            time = TimeDimension('time')
            tdim = time if full_save else \
                SteppingDimension('t', parent=time)
        cls._time_dim_ = tdim
        return (tdim,) + cls._space_dimensions

    # position of the time axis in `shape`
    _time_position = 0

    @property
    def time_dim(self):
        return type(self)._time_dim_

    @property
    def save(self):
        return type(self)._save

    @property
    def _time_buffering(self):
        """True when time-stepping uses a modulo rolling buffer (save is
        None or a Buffer); False for full save."""
        return type(self)._save is None or isinstance(type(self)._save,
                                                      Buffer)

    @property
    def _time_size(self):
        cls = type(self)
        if isinstance(cls._save, Buffer):
            return cls._save.size
        if cls._save is not None:
            return cls._save
        if isinstance(cls._time_dim_, ConditionalDimension):
            return None  # must be given via save
        return cls._time_order + 1

    @property
    def shape(self):
        return (self._time_size,) + type(self)._space_shape

    @property
    def shape_with_halo(self):
        return (self._time_size,) + tuple(
            n + l + r for n, (l, r) in zip(type(self)._space_shape,
                                           self.halo))

    @property
    def shape_allocated(self):
        return (self._time_size,) + self._allocated_space()

    @property
    def halo(self):
        return type(self)._halo  # space-only; callers index by space dim

    def _leading_slices(self):
        return (slice(None),)

    def _domain_view(self, buf):
        slices = (slice(None),) + tuple(
            slice(l, l + n) for n, (l, r) in zip(type(self)._space_shape,
                                                 type(self)._halo))
        return buf[slices]

    # -- time shifts ------------------------------------------------------

    @property
    def forward(self):
        """u at the next time slot (reference: TimeFunction.forward)."""
        return self._subs_index(0, 1)

    @property
    def backward(self):
        return self._subs_index(0, -1)
