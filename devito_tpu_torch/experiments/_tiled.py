"""What the five tiled-design probes share (``stencil_probe`` and
``stencil_probe2`` to ``stencil_probe5``): the acoustic SO=8 weights, the
Laplacian in the order the JAX kernels sum their taps, argument checks,
the comparison against a plain version and the printed timing lines.

All five compute ``2 uc - up + m lap(uc)`` (K3 also ``- damp uc``) in
fp32 over padded layouts with a halo of H = 4 points. K4, K5, K6 and K7
share one CUDA unit, ``csrc/probe_tiles_stream.cu``: a point of K1's
streaming engine (``csrc/stencil_stream.cuh``) with one staged group (uc)
and two centre groups (up, m), a kernel that writes the zeros of a frame
around the update (``stream_step``; ``frame_reference`` is its plain
version), and a kernel for K4's x-halo rows
(``stencil_probe2.edge_rows``).
"""

import numpy as np
import torch

from . import _stream, time_ms

__all__ = ['H', 'W', 'TOL', 'STREAM_TILES', 'STREAM_TILE', 'lap',
           'lap_interior', 'run_interior', 'check', 'apart', 'stream',
           'frame', 'frame_reference', 'stream_step', 'close', 'timed_run',
           'FLOPS']

H = 4  # SO=8 stencil radius, and the halo of every layout
#: SO=8 second-derivative weights, centre at index 4, as the JAX scripts'.
W = [np.float32(w) for w in [-1/560, 8/315, -1/5, 8/5, -205/72, 8/5, -1/5,
                             8/315, -1/560]]
TOL = 1e-5      # times max |plain|: fp32 sums in another order
#: fp32 operations per point of 2 uc - up + m lap(uc): 27 taps as a multiply
#: and an add, less the first add, and 4 for the rest (K3's ``- damp uc``
#: adds 2).
FLOPS = 57
#: The tiles (TY, TZ, PY, STAGES) that ``csrc/probe_tiles_stream.cu`` is
#: compiled for, in the order its flags pick them, with the CTAs an SM that
#: ``stream_tile`` fits by shared memory at one staged and two centre groups
#: of radius 4: K1's fp32 tile (77,440 B, two), the same with two stages
#: (61,440 B, three), a (16, 32) tile of two points a thread with three
#: stages (43,648 B, five) and K1's with four stages (93,440 B, two); the
#: registers may allow fewer.
STREAM_TILES = ((16, 64, 4, 3), (16, 64, 4, 2), (16, 32, 2, 3),
                (16, 64, 4, 4))
#: The tile K4, K5, K6 and K7 launch, with K3's and K9's x-chunk
#: (``_stream.X_CHUNK``): of STREAM_TILES and ``_stream.X_CHUNKS``, the
#: fastest for each of the four at 512^3 on an H100, or within 0.3 % of
#: it (chip_smoke.py sweeps both; PERF.md §6).
STREAM_TILE = STREAM_TILES[0]


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


def stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def frame(out, outer, inner):
    """The 12 frame parameters of ``csrc/probe_tiles_stream.cu``: the
    boxes ``outer`` and ``inner``, each an (origin, extent) pair in the
    elements of the 3-D view ``out``, as origin and extent in the
    allocation ``out`` lies in (``_stream.allocation``). The frame is every
    point of ``outer`` outside ``inner``."""
    first = _stream.allocation(out)[2]
    return tuple(v for org, ext in (outer, inner)
                 for v in (*(f + o for f, o in zip(first, org)), *ext))


def frame_reference(out, params):
    """The plain version of the frame kernel: zeros over the frame of the
    12 ``params`` (``frame``) in the allocation the 3-D view ``out`` lies
    in (``_stream.whole``)."""
    alloc = _stream.whole(out)[0]
    boxes = [tuple(slice(o, o + e) for o, e in zip(params[k:k + 3],
                                                   params[k + 3:k + 6]))
             for k in (0, 6)]
    mask = torch.zeros(alloc.shape, dtype=torch.bool, device=alloc.device)
    mask[boxes[0]] = True
    mask[boxes[1]] = False
    alloc[mask] = 0.0


def stream_step(what, rows, n, frame_, x_chunk, tile, device, zeros=True):
    """Launch ``csrc/probe_tiles_stream.cu`` on the engine's ``rows``
    (``_stream.rows``: out, uc staged, up and m centre) over the region
    ``n``, each CTA walking ``x_chunk`` x-planes, compiled for ``tile`` (of
    STREAM_TILES); first, given ``zeros``, the frame kernel over the frame
    ``frame_`` (12 parameters from ``frame``)."""
    if tile not in STREAM_TILES:
        raise ValueError(f"tile {tile}: expected one of {STREAM_TILES}")
    _stream.launch(what, 'probe_tiles_stream', rows, n, x_chunk, device,
                   frame_, int(zeros) + 2 * STREAM_TILES.index(tile))


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
