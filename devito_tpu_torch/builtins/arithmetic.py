"""Reduction builtins: norm, inner, mmin, mmax, sum.

Reference parity: devito/builtins/arithmetic.py:11-209 (norm, sumall,
inner, mmin, mmax). Computed with torch on the device tensor's domain
region, in the function's own dtype (a narrow-stored tensor is widened
to it)."""

import torch

__all__ = ['norm', 'inner', 'mmin', 'mmax', 'mmax_abs', 'sumall', 'sum_all']


def _domain_dev(f):
    """Device view of the domain region (drop halo), in the compute
    dtype."""
    from ..types.dense import widen
    arr = f._device_array()
    if f.is_SparseFunction:
        return arr
    slices = f._leading_slices() + tuple(
        slice(l, l + n) for n, (l, r) in zip(
            f.shape if not f.is_TimeFunction else f.shape[1:], f.halo))
    return widen(arr[slices], f)


def norm(f, order=2):
    """lp-norm of a function over its domain."""
    v = _domain_dev(f)
    if order == 2:
        return float(torch.sqrt(torch.sum(v * v)))
    return float(torch.sum(torch.abs(v) ** order) ** (1.0 / order))


def inner(f, g):
    """Inner product <f, g> over the domain."""
    return float(torch.sum(_domain_dev(f) * _domain_dev(g)))


def mmin(f):
    return float(torch.min(_domain_dev(f)))


def mmax(f):
    return float(torch.max(_domain_dev(f)))


def mmax_abs(f):
    return float(torch.max(torch.abs(_domain_dev(f))))


def sumall(f):
    return float(torch.sum(_domain_dev(f)))


sum_all = sumall
