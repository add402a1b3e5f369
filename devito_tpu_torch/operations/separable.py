"""Separable (tensor-product) sparse interpolation.

Reference parity: devito_tpu/operations/separable.py (its
``_host_dim_weights``, ``separable_geometry`` and ``linear_terms``), with
the contraction of ``devito_tpu/compiler/executor.py`` ``_interp_separable``
here as ``contract``.

Most acquisition geometries are tensor products: a surface receiver grid
is ``{x_i} x {y_j} x {z0}``, a receiver line ``{x_i} x {z0}``. When the
runtime coordinates factorise so, interpolation is a chain of per-axis
contractions with small weight matrices instead of a gather of every
point's corners. The factorisation runs on the host at each
``Operator.apply`` (the coordinates are concrete there); the weight
matrices go to the device with the other runtime tensors.

Weights, clipping and out-of-bounds points follow the gather path
(``compiler/executor.py`` ``_sparse_geometry``) exactly: ``base =
floor(px)``, corner indices clipped to ``[0, n-1]`` (duplicates
accumulate), a point whose position leaves ``[0, n-1]`` on any axis
contributes zero.

Each weight matrix ``M_j`` keeps only its band, the rows from its first
nonzero row to its last: the rows outside carry exact zeros, so the
contraction reads only that band of the sampled field (for a surface grid,
2 z-planes under linear weights, 2r under sinc). The axes are contracted
in the order of their distinct positions, fewest first.
"""

from collections import namedtuple

import numpy as np

__all__ = ['separable_geometry', 'linear_terms', 'Separable', 'to_device',
           'contract']

#: The device side of a factorised geometry: ``M``, per grid axis, the band
#: of its (n_j, n_uj) weight matrix as a tensor, rows ``lo[j]`` to
#: ``lo[j] + M[j].shape[0] - 1``; ``order``, the axes in contraction order;
#: ``code``, a (P,) int64 tensor taking each point to its slot in the
#: product order, or None when that map is the identity.
Separable = namedtuple('Separable', 'M lo order code')


def _host_dim_weights(interp, px):
    """Numpy mirror of the interpolators' ``dim_weights``: (offsets, list
    of weight arrays, base indices)."""
    base = np.floor(px).astype(np.int64)
    frac = px - base
    name = getattr(interp, 'name', '')
    if name == 'linear':
        return [0, 1], [1.0 - frac, frac], base
    if name == 'sinc':
        r, b = interp.r, interp._b_table[interp.r]
        b0 = float(np.i0(b))
        offsets = list(range(-r + 1, r + 1))
        ws = []
        for off in offsets:
            rpos = off - frac
            arg = np.maximum(1.0 - (rpos / r) ** 2, 0.0)
            ws.append(np.i0(b * np.sqrt(arg)) / b0 * np.sinc(rpos))
        return offsets, ws, base
    raise NotImplementedError(name)


def separable_geometry(sf, params, min_points=1024):
    """Try to factorise ``sf``'s coordinates into a tensor product of
    per-axis position sets.

    Returns None (not separable, or below ``min_points`` points), or a
    dict with ``M``, the per-axis weight matrices, each (n_j, n_uj) with
    n_j the domain extent of grid axis j, and ``code``, a (P,) int32 map
    from each point to its slot in the raveled product order, or None
    when that map is the identity.
    """
    interp = sf.interpolator
    if getattr(interp, 'name', '') not in ('linear', 'sinc'):
        return None
    npoint = sf.npoint or 0
    if npoint < min_points:
        return None
    coords = np.asarray(type(sf)._coords_host)
    if coords.ndim != 2 or len(coords) != npoint:
        return None
    grid = sf.grid

    uniqs, invs, counts = [], [], []
    total = 1
    for j in range(coords.shape[1]):
        u, iv = np.unique(coords[:, j], return_inverse=True)
        uniqs.append(u)
        invs.append(iv.reshape(-1))
        counts.append(len(u))
        total *= len(u)
    if total != npoint:
        return None
    code = np.ravel_multi_index(tuple(invs), tuple(counts))
    # a bijection: every combination of the product occurs exactly once
    seen = np.zeros(total, dtype=bool)
    seen[code] = True
    if not seen.all():
        return None

    dtype = np.float64 if np.dtype(sf.dtype) == np.float64 else np.float32
    Ms = []
    for j, d in enumerate(grid.dimensions):
        n = grid.shape[j]
        h = params.get(d.spacing.name, grid.spacing[j])
        o = grid.origin[j]
        pu = (uniqs[j] - o) / h
        offsets, wlist, base = _host_dim_weights(interp, pu)
        valid = (pu >= 0) & (pu <= n - 1)
        M = np.zeros((n, len(pu)), dtype=dtype)
        cols = np.arange(len(pu))
        for off, w in zip(offsets, wlist):
            rows = np.clip(base + off, 0, n - 1)
            np.add.at(M, (rows, cols), np.where(valid, w, 0.0))
        Ms.append(M)

    identity = bool(np.array_equal(code, np.arange(npoint)))
    return {'M': Ms, 'code': None if identity else code.astype(np.int32)}


def to_device(sep, device):
    """The ``Separable`` of the host geometry ``sep`` on ``device``: each
    matrix cut to its band of nonzero rows (one zero row when it has
    none), the contraction order, the point map."""
    import torch
    Ms, lo = [], []
    for M in sep['M']:
        nz = np.flatnonzero(np.any(M != 0, axis=1))
        a, b = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 1)
        Ms.append(torch.from_numpy(np.ascontiguousarray(M[a:b])).to(device))
        lo.append(a)
    order = tuple(sorted(range(len(Ms)), key=lambda j: (Ms[j].shape[1], j)))
    code = sep['code']
    return Separable(tuple(Ms), tuple(lo), order, None if code is None else
                     torch.from_numpy(code.astype(np.int64)).to(device))


def contract(sub, sep):
    """The (P,) interpolated values of the sampled field's band ``sub``
    (its axis j spans rows ``sep.lo[j]`` onwards, as many as ``sep.M[j]``
    has), in point order: one ``tensordot`` per axis in ``sep.order``,
    then the product order raveled and mapped to the points."""
    import torch
    ndim = len(sep.M)
    axes = list(range(ndim))    # grid axis held at each position of sub
    for j in sep.order:
        k = axes.index(j)
        sub = torch.tensordot(sub, sep.M[j], dims=([k], [0]))
        axes = axes[:k] + axes[k + 1:] + [j]
    sub = sub.permute([axes.index(j) for j in range(ndim)])
    res = sub.reshape(-1)
    return res if sep.code is None else res[sep.code]


def linear_terms(expr):
    """Decompose a sampled expression into ``[(coeff, access), ...]``,
    each access a dense applied function (perhaps offset or time-indexed)
    and each coeff a float; or None when the expression is not such a
    linear combination (nonlinear terms, constant offsets, sparse
    factors).

    Interpolated expressions are linear in the sampled fields once
    evaluated (u + v, div(v) -> offset taps of the components), so the
    separable contraction distributes over the terms."""
    import sympy
    from ..types.basic import AbstractFunction

    terms = []

    def rec(e, c):
        if isinstance(e, AbstractFunction):
            if e.function.is_SparseFunction:
                return False
            terms.append((c, e))
            return True
        if e.is_Add:
            return all(rec(a, c) for a in e.args)
        if e.is_Mul:
            nums = [a for a in e.args if a.is_number]
            rest = [a for a in e.args if not a.is_number]
            if len(rest) != 1:
                return False
            return rec(rest[0], c * float(sympy.Float(sympy.Mul(*nums))))
        return False

    if not rec(expr, 1.0):
        return None
    return terms
