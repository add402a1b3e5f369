"""Global-indexing view over a distributed function's device tensor.

Reference parity: devito_tpu/data.py ``Data`` (itself devito/data/data.py
``Data``: global domain indices whatever the decomposition). A function of
a distributed Grid keeps its whole halo'd tensor on its device between
applies (parallel/halo.py), as devito_tpu keeps one global jax.Array;
once an apply has written it, ``.data`` hands out this view instead of a
host copy. Indexing follows numpy's rules (basic, negative-step, integer-
array and boolean-mask indices, Ellipsis): a read copies the bounding box
of the selected elements to the host and indexes it there; a write reads
that box, writes into it there, and copies it back. The whole tensor
crosses to the host only for ``np.asarray`` (``__array__``) or a box that
spans it. ``min``, ``max``, ``sum``, ``all`` and ``any`` reduce on the
device; only the scalar reaches the host.
"""

import numpy as np
import torch

__all__ = ['Data']


def _ndim_of(i):
    """The axes an index element consumes."""
    if i is None:
        return 0
    if isinstance(i, (list, np.ndarray)):
        a = np.asarray(i)
        return a.ndim if a.dtype == bool else 1
    return 1


class Data:
    """A lazy view over a function's device tensor in domain coordinates
    (the halo hidden, as the host ``.data`` view hides it)."""

    def __init__(self, fn):
        self._fn = fn

    # -- shape/dtype protocol ---------------------------------------------

    @property
    def shape(self):
        return self._fn.shape

    @property
    def ndim(self):
        return len(self._fn.shape)

    @property
    def dtype(self):
        return self._fn.dtype

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return (f"Data<{self._fn.name}, shape={self.shape}, "
                f"device-resident on {self._fn.device}>")

    # -- index mapping -----------------------------------------------------

    def _box(self, idx):
        """``(box, local)``: per axis the domain range ``[lo, hi)`` the
        index ``idx`` touches, and ``idx`` rewritten relative to that box
        (numpy semantics, IndexError as numpy raises it)."""
        shape = self.shape
        if not isinstance(idx, tuple):
            idx = (idx,)
        if sum(i is Ellipsis for i in idx) > 1:
            raise IndexError("an index can only have a single ellipsis")
        if any(i is Ellipsis for i in idx):
            pos = next(k for k, i in enumerate(idx) if i is Ellipsis)
            fill = len(shape) - sum(_ndim_of(i) for i in idx
                                    if i is not Ellipsis)
            idx = idx[:pos] + (slice(None),) * fill + idx[pos + 1:]
        used = sum(_ndim_of(i) for i in idx)
        if used > len(shape):
            raise IndexError(f"too many indices: {used} for {len(shape)} "
                             f"axes")
        idx = idx + (slice(None),) * (len(shape) - used)
        box, local = [], []
        axis = 0
        for i in idx:
            if i is None:
                local.append(None)
                continue
            if isinstance(i, (list, np.ndarray)) and \
                    np.asarray(i).dtype == bool:
                m = np.asarray(i)
                want = tuple(shape[axis:axis + m.ndim])
                if m.shape != want:
                    raise IndexError(
                        f"boolean mask shape {m.shape} does not match axes "
                        f"{axis}.. sizes {want}")
                nz = np.nonzero(m)
                rng = [(int(c.min()), int(c.max()) + 1) if c.size else (0, 0)
                       for c in nz]
                box.extend(rng)
                local.append(m[tuple(slice(a, b) for a, b in rng)])
                axis += m.ndim
                continue
            n = shape[axis]
            if isinstance(i, (int, np.integer)):
                k = int(i) + (n if i < 0 else 0)
                if not 0 <= k < n:
                    raise IndexError(f"index {int(i)} is out of bounds for "
                                     f"axis {axis} with size {n}")
                box.append((k, k + 1))
                local.append(0)
            elif isinstance(i, slice):
                r = range(*i.indices(n))
                if not r:
                    box.append((0, 0))
                    local.append(slice(0, 0))
                else:
                    lo, hi = min(r[0], r[-1]), max(r[0], r[-1]) + 1
                    box.append((lo, hi))
                    first, last = r[0] - lo, r[-1] - lo
                    stop = last + (1 if r.step > 0 else -1)
                    local.append(slice(first, None if stop < 0 else stop,
                                       r.step))
            elif isinstance(i, (list, np.ndarray)):
                a = np.asarray(i)
                if not np.issubdtype(a.dtype, np.integer) and a.size:
                    raise IndexError("arrays used as indices must be of "
                                     "integer or boolean type")
                a = a.astype(np.int64)
                if a.size and (a.min() < -n or a.max() >= n):
                    raise IndexError(f"index array out of bounds for axis "
                                     f"{axis} with size {n}")
                a = np.where(a < 0, a + n, a)
                lo, hi = (int(a.min()), int(a.max()) + 1) if a.size else \
                    (0, 0)
                box.append((lo, hi))
                local.append(a - lo)
            else:
                raise IndexError(f"unsupported index {i!r}")
            axis += 1
        return box, tuple(local)

    def _view(self, box):
        """The device tensor's region of the domain box ``box``."""
        fn = self._fn
        dev = fn._device_array()
        nlead = len(self.shape) - len(fn.halo)
        return dev[tuple(slice(a + (fn.halo[k - nlead][0] if k >= nlead
                                    else 0),
                               b + (fn.halo[k - nlead][0] if k >= nlead
                                    else 0))
                         for k, (a, b) in enumerate(box))]

    def _host(self, view):
        from .types.dense import widen
        return widen(view, self._fn).cpu().numpy()

    # -- reads -------------------------------------------------------------

    def __getitem__(self, idx):
        box, local = self._box(idx)
        out = self._host(self._view(box))[local]
        return out[()] if isinstance(out, np.ndarray) and out.ndim == 0 \
            else out

    def _gather(self):
        return self._host(self._view([(0, n) for n in self.shape]))

    def __array__(self, dtype=None, copy=None):
        out = self._gather()
        if dtype is not None:
            out = out.astype(dtype)
        return out

    # -- writes (device-resident) -----------------------------------------

    def __setitem__(self, idx, value):
        box, local = self._box(idx)
        view = self._view(box)
        host = self._host(view)
        host[local] = value
        view.copy_(torch.from_numpy(host).to(device=view.device,
                                             dtype=view.dtype))
        self._fn._set_device_array(self._fn._device_array())

    # -- numpy conveniences ------------------------------------------------

    def copy(self):
        return self._gather()

    def _reduce(self, name, *a, **k):
        """A whole-array reduction on the device (a narrow tensor sums in
        its compute dtype); axis and keyword forms go through the host."""
        if a or k:
            return getattr(self._gather(), name)(*a, **k)
        from .types.dense import widen
        view = widen(self._view([(0, n) for n in self.shape]), self._fn)
        fns = {'min': torch.amin, 'max': torch.amax, 'sum': torch.sum,
               'all': torch.all, 'any': torch.any}
        return fns[name](view).cpu().numpy()[()]

    def min(self, *a, **k):
        return self._reduce('min', *a, **k)

    def max(self, *a, **k):
        return self._reduce('max', *a, **k)

    def sum(self, *a, **k):
        return self._reduce('sum', *a, **k)

    def all(self, *a, **k):
        return self._reduce('all', *a, **k)

    def any(self, *a, **k):
        return self._reduce('any', *a, **k)
