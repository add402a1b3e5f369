"""Redistribution of function data between decompositions.

Reference parity: devito_tpu/parallel/redistribute.py (the analog of the
reference's distributed indexing engine, devito/data/distributed/). A
function's tensor is whole between applies, whatever its Grid's topology
(parallel/halo.py), so moving data between two decompositions is a
device-side copy of the domain from one function's tensor into the
other's, on its device and in its storage dtype, with a zero halo; the
shards of the destination's topology are cut from it at its next apply.
"""

import torch

__all__ = ['redistribute']


def _interior_device(fn):
    """The device view of ``fn``'s domain (halo stripped), in its compute
    dtype."""
    from ..types.dense import widen
    dev = fn._device_array()
    lead = fn._leading_slices()
    ns = fn.shape[len(lead):]
    return widen(dev[tuple(lead) + tuple(slice(hl, hl + n) for n, (hl, hr)
                                         in zip(ns, fn.halo))], fn)


def redistribute(src, dst):
    """Copy ``src``'s domain data into ``dst``, device to device, and
    return ``dst``.

    ``src`` and ``dst`` must have the same domain shape, time axis (a
    ``save`` history or a rolling buffer) included; they may live on grids
    of different topologies (or one unsharded), with different halos and
    storage dtypes (``dst`` rounds to its own). ``dst``'s halo is zeroed.
    """
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(
            f"redistribute: shape mismatch {src.shape} vs {dst.shape}")
    from ..types.dense import torch_dtype
    interior = _interior_device(src)
    cls = type(dst)
    dt = getattr(cls, '_storage', None) or torch_dtype(dst.dtype)
    buf = torch.zeros(tuple(dst.shape_allocated), dtype=dt,
                      device=dst.device)
    lead = dst._leading_slices()
    ns = dst.shape[len(lead):]
    buf[tuple(lead) + tuple(slice(hl, hl + n) for n, (hl, hr)
                            in zip(ns, dst.halo))] = interior.to(
        device=dst.device, dtype=dt)
    dst._allocate()
    dst._set_device_array(buf)
    cls._pristine_zero = False
    cls._halo_state = 'zero'
    return dst
