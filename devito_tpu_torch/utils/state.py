"""Carrying state between packages as numpy arrays.

``numpy_state`` reads functions through their host views — works on any
object with the reference API (``data_with_halo``, ``coordinates.data``),
so it also reads the JAX package's functions without importing it, and
never sees a device-only layout. ``load_numpy_state`` writes such arrays
into this package's functions, so both packages compute from identical
state. Precomputed and matrix sparse functions also carry their
gridpoints, coefficient tables and coupling matrix. A function's
``halo_state`` travels with its halo: reading ``data_with_halo`` would
mark it 'dirty' (a user may write the halo through it), which here only
copies it, and a distributed run needs to know that the halo is still
'zero' or 'edge' (parallel/halo.py). A function of a distributed Grid is
carried as its global array, whole, as any other.
"""

import numpy as np

__all__ = ['numpy_state', 'load_numpy_state']


def _by_name(functions):
    if isinstance(functions, dict):
        return dict(functions)
    return {f.name: f for f in functions}


def _tables(f):
    """{suffix: array} of a precomputed or matrix sparse function's
    gridpoints, coefficient tables (a matrix function's per dimension)
    and coupling matrix, as the function holds them; {} otherwise."""
    if hasattr(f, 'interpolation_coeffs'):
        out = dict(gridpoints=f.gridpoints, coeffs=f.interpolation_coeffs)
    elif hasattr(f, 'interpolation_coefficients'):
        out = dict(gridpoints=f.gridpoints, matrix=f.matrix)
        out.update({f'coeffs_{d.name}': c for d, c
                    in f.interpolation_coefficients.items()})
    else:
        return {}
    return {k: v for k, v in out.items() if v is not None}


def numpy_state(functions):
    """{name: copy of ``data_with_halo``} per function, plus
    ``<name>_coords`` for sparse functions, ``<name>_<table>`` for the
    tables of precomputed and matrix ones (``_tables``) and
    ``<name>_halo_state`` where the function has one."""
    out = {}
    for name, f in _by_name(functions).items():
        if getattr(f, 'is_SparseFunction', False):
            out[name] = np.array(f.data)
            out[f'{name}_coords'] = np.array(f.coordinates.data)
            for k, v in _tables(f).items():
                out[f'{name}_{k}'] = np.array(v)
        else:
            state = getattr(f, 'halo_state', None)
            out[name] = np.array(f.data_with_halo)
            if state is not None:
                type(f)._halo_state = state
                out[f'{name}_halo_state'] = np.array(state)
    return out


def load_numpy_state(functions, arrays):
    """Write ``arrays`` (as from ``numpy_state``) into ``functions``, a
    list or {name: function} of this package's functions. Each array must
    match the function's ``data_with_halo`` (sparse: ``data``,
    ``coordinates.data`` and the tables of ``_tables``) in shape; values
    are cast to its dtype."""
    for name, f in _by_name(functions).items():
        if name not in arrays:
            raise KeyError(f"no state for {name}")
        pairs = [(f.data_with_halo if not f.is_SparseFunction else f.data,
                  arrays[name])]
        if f.is_SparseFunction:
            pairs.append((f.coordinates.data, arrays[f'{name}_coords']))
            pairs += [(v, arrays[f'{name}_{k}'])
                      for k, v in _tables(f).items()]
        for dst, src in pairs:
            src = np.asarray(src)
            if src.shape != dst.shape:
                raise ValueError(f"{name}: state of shape {src.shape} for "
                                 f"a view of shape {dst.shape}")
            dst[...] = src.astype(dst.dtype, copy=False)
        if f'{name}_halo_state' in arrays:
            type(f)._halo_state = str(arrays[f'{name}_halo_state'])
