"""What the five tiled-design probes share (``stencil_probe`` and
``stencil_probe2`` to ``stencil_probe5``): the acoustic SO=8 weights, the
Laplacian in the order the JAX kernels sum their taps, argument checks,
the comparison against a plain version and the printed timing lines.

All five compute ``2 uc - up + m lap(uc)`` (K3 also ``- damp uc``) in
fp32 over padded layouts with a halo of H = 4 points.
"""

import numpy as np
import torch

from . import time_ms

__all__ = ['H', 'W', 'TOL', 'SMEM', 'YZ_PLANE', 'lap', 'lap_interior',
           'run_interior', 'check', 'apart', 'aligned', 'stream', 'z_chunk',
           'close', 'timed_run', 'FLOPS']

H = 4  # SO=8 stencil radius, and the halo of every layout
#: SO=8 second-derivative weights, centre at index 4, as the JAX scripts'.
W = [np.float32(w) for w in [-1/560, 8/315, -1/5, 8/5, -205/72, 8/5, -1/5,
                             8/315, -1/560]]
TOL = 1e-5      # times max |plain|: fp32 sums in another order
#: fp32 operations per point of 2 uc - up + m lap(uc): 27 taps as a multiply
#: and an add, less the first add, and 4 for the rest (K3's ``- damp uc``
#: adds 2).
FLOPS = 57
SMEM = 232448   # bytes of shared memory a block may use on Hopper
#: Floats of one halo'd (SY, SZ) = (8, 32) plane of the shared windows of
#: the x-tiled kernels (probe2_neighbour_blocks.cu, probe5_xtiles.cu).
YZ_PLANE = (8 + 2 * H) * (32 + 2 * H)


def lap(u, origin, extent, axes=(0, 1, 2), out=None):
    """sum over ``axes`` (x, y, z, in that order) and taps k = -4..4 of
    W[k+4] * u shifted by k along the axis, over the box of ``u`` at
    ``origin`` of size ``extent``, added term by term to ``out`` if given:
    the JAX scripts' ``lap_interior``."""
    for axis in axes:
        for i, w in enumerate(W):
            idx = [slice(o, o + e) for o, e in zip(origin, extent)]
            idx[axis] = slice(origin[axis] + i - H,
                              origin[axis] + i - H + extent[axis])
            t = float(w) * u[tuple(idx)]
            out = t if out is None else out + t
    return out


def lap_interior(u, x0=H):
    """The SO=8 Laplacian over the interior of the padded field ``u``: the
    cube of side n = u.shape[1] - 8 at (x0, 4, 4)."""
    n = u.shape[1] - 2 * H
    return lap(u, (x0, H, H), (n, n, n))


def run_interior(u0, u1, m, nsteps, damp=None, x0=H):
    """The JAX scripts' variant A: ``nsteps`` updates ``2 uc - up +
    m lap(uc)`` (and ``- damp uc`` given ``damp``) of the interior of
    ``lap_interior``, each written into up's interior, with (up, uc)
    starting at (u0, u1) and rotating; returns the last pair. u0 and u1
    are updated in place, as the JAX loop donates them."""
    up, uc = u0, u1
    n = u0.shape[1] - 2 * H
    box = (slice(x0, x0 + n), slice(H, H + n), slice(H, H + n))
    for _ in range(nsteps):
        ucc = uc[box]
        val = 2.0 * ucc - up[box] + m * lap_interior(uc, x0)
        up[box] = val if damp is None else val - damp * ucc
        up, uc = uc, up
    return up, uc


def check(what, dense, views=()):
    """Raise unless every tensor is a 3-D fp32 tensor on one cpu or cuda
    device: those of ``dense`` contiguous, those of ``views`` (may be None)
    contiguous along z (the last axis)."""
    views = [t for t in views if t is not None]
    for t in (*dense, *views):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or t.dim() != 3 or t.stride(2) != 1:
            raise TypeError(f"the {what} takes 3-D fp32 tensors, "
                            f"contiguous along z")
        if t.device != dense[0].device:
            raise ValueError(f"the {what}'s tensors lie on different "
                             f"devices")
    if any(not t.is_contiguous() for t in dense):
        raise TypeError(f"the {what} takes contiguous fp32 tensors")
    if dense[0].device.type not in ('cpu', 'cuda'):
        raise ValueError(f"no {what} kernel for device {dense[0].device}")


def apart(what, out, uc):
    """Raise when ``out`` shares storage with ``uc``, which the kernel
    reads around every point it writes."""
    if out is not None and out.untyped_storage().data_ptr() == \
            uc.untyped_storage().data_ptr():
        raise ValueError(f"the {what}'s output shares storage with uc")


def aligned(what, *tensors):
    """Raise unless each tensor starts on a 16-byte boundary (cp.async)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {what} kernel needs 16-byte aligned tensors")


def stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def z_chunk(what, tx, ty, windows):
    """The z extent of a (tx, ty) tile's block: the largest of 32, 16, 8
    and 4 for which ``windows`` halo'd windows (tx+8, ty+8, zc+8) of fp32
    fit in shared memory. Raises when none does."""
    for zc in (32, 16, 8, 4):
        if windows * (tx + 2 * H) * (ty + 2 * H) * (zc + 2 * H) * 4 <= SMEM:
            return zc
    raise ValueError(f"the {what} kernel cannot fit {windows} window(s) of a "
                     f"({tx}, {ty}) tile in {SMEM} bytes of shared memory")


def close(what, got, want):
    """max |got - want| and the tolerance TOL * max |want|; raises
    AssertionError beyond it."""
    err = (got - want).abs().max().item()
    tol = TOL * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: max|err| {err:.3e} > {tol:.3e}")
    return err, tol


def timed_run(label, fn, n, steps, dev):
    """Milliseconds of one call of ``fn`` (a ``steps``-step run) after a
    warm-up call, printed with GPts/s over n^3 points per step as the JAX
    scripts print them; returns the milliseconds."""
    ms = time_ms(fn, 1, dev)
    print(f"{label}: {ms:.1f} ms, {n ** 3 * steps / ms / 1e6:.2f} GPts/s",
          flush=True)
    return ms
