"""What K9 (``stencil_probe6``) and K3 (``stencil_probe``) share: a
hand-written point launched on K1's streaming engine
(``csrc/stencil_stream.cuh``), and the rows that engine takes.

Both probes compute the acoustic SO=8 update with one staged group (read
along the three axes to radius 4: u[t] for K9, uc for K3) and three centre
groups (read at the point), the group count of K1's acoustic update, so
both units are compiled for K1's fp32 tile (``TILE``). A row is a whole
allocation given by its base pointer, its extents (x, y, z) and the
element (x, y, z) of the region's first point in it; the target is written
with plain stores through those extents, the other rows are read by TMA.
Each unit exports ``dtpu_probe_stream_launch`` and
``dtpu_probe_stream_occupancy``. K4, K5, K6 and K7
(``_tiled.stream_step``) launch their unit, ``csrc/probe_tiles_stream.cu``,
through the same rows and ``launch``, with two centre groups and tiles of
their own (``_tiled.STREAM_TILES``).
"""

import ctypes

import torch

from ..kernels import _nvcc
from ..kernels.stencil import STREAM_TILE

__all__ = ['RADII', 'TILE', 'X_CHUNK', 'X_CHUNKS', 'allocation', 'whole',
           'rows', 'launch', 'occupancy']

#: The staged group's radius along x, y and z (SO=8).
RADII = (4, 4, 4)
#: The tile (TY, TZ, PY, STAGES) that ``csrc/probe6_stream.cu`` and
#: ``csrc/probe_halo_stream.cu`` are compiled for: K1's fp32 tile, which
#: ``stream_tile`` fits at two CTAs an SM for one staged and three centre
#: groups of radius 4 (their tests check both).
TILE = STREAM_TILE[4][:4]
#: x-planes a CTA walks, a run-time argument of either probe's launch:
#: of ``X_CHUNKS``, the fastest for K9 and within 2 % of the fastest for
#: K3 at 512^3 on an H100 (chip_smoke.py sweeps them; PERF.md §6), where
#: K1 walks 32.
X_CHUNK = 24
X_CHUNKS = (8, 16, 24, 32, 64, 128)


def allocation(t):
    """(base pointer, extents (x, y, z), first element (x, y, z)) of the
    contiguous allocation the 3-D view ``t`` lies in, as its strides and
    storage offset describe it: a new tensor gives its own extents and
    (0, 0, 0); the interior view ``u[4:-4, 4:-4, 4:-4]`` of an (n+8)^3
    tensor gives (n+8, n+8, n+8) and (4, 4, 4). Raises unless the strides
    are those of a contiguous allocation holding the view: z-stride 1, a
    y-stride of at least the view's z extent and an x-stride that is a
    multiple of it, of at least its y extent."""
    if t.dim() != 3:
        raise ValueError(f"a {t.dim()}-D view: expected 3-D")
    (nx, ny, nz), (sx, sy, sz) = t.shape, t.stride()
    if sz != 1 or sy < nz or sx % sy or sx // sy < ny:
        raise ValueError(f"a view of strides {(sx, sy, sz)} and shape "
                         f"{tuple(t.shape)} is not a box of a contiguous "
                         f"allocation")
    size = t.untyped_storage().nbytes() // t.element_size()
    off = t.storage_offset()
    dims = (size // sx, sx // sy, sy)
    org = (off // sx, off % sx // sy, off % sy)
    if any(o + e > d for o, e, d in zip(org, t.shape, dims)):
        raise ValueError(f"a view of shape {tuple(t.shape)} at {org} runs "
                         f"past its allocation {dims}")
    return t.untyped_storage().data_ptr(), dims, org


def whole(t):
    """(the contiguous tensor over the whole allocation the 3-D view ``t``
    lies in, the element of ``t``'s first point in it), from
    ``allocation``: a read row for a view, such as up's interior columns
    (K6), which ``rows`` refuses as it is."""
    _, dims, first = allocation(t)
    return t.as_strided(dims, (dims[1] * dims[2], dims[2], 1), 0), first


def rows(what, target, staged, centre):
    """The engine's rows as ctypes arrays (base pointers, extents,
    origins): ``target``, then ``staged`` and ``centre``, each a (tensor,
    the element of the region's first point in it) pair. The target may
    be any 3-D view that ``allocation`` takes, its origin counted from the
    view's first element; the others are contiguous tensors that TMA
    reads, so each must start on a 16-byte boundary with z rows of whole
    16-byte units, and each box must start on one in z: a staged group's
    first z (origin - 4) and a centre group's origin are multiples of 16
    bytes. Raises otherwise."""
    view, org = target
    base, dims, first = allocation(view)
    ents = [(base, dims, tuple(f + o for f, o in zip(first, org)))]
    for k, (t, org) in enumerate(staged + centre):
        rz = RADII[2] if k < len(staged) else 0
        align = 16 // t.element_size()
        if not t.is_contiguous() or t.data_ptr() % 16 \
                or t.shape[2] % align or (org[2] - rz) % align:
            raise ValueError(f"the {what} kernel needs contiguous, 16-byte "
                             f"aligned tensors with z rows of whole 16-byte "
                             f"units and boxes starting on one (TMA): shape "
                             f"{tuple(t.shape)}, first box at z = "
                             f"{org[2] - rz}")
        ents.append((t.data_ptr(), tuple(t.shape), tuple(org)))
    k = len(ents)
    return ((ctypes.c_void_p * k)(*[e[0] for e in ents]),
            (ctypes.c_longlong * (3 * k))(*[d for e in ents for d in e[1]]),
            (ctypes.c_int * (3 * k))(*[o for e in ents for o in e[2]]))


def launch(what, unit, rows_, n, x_chunk, device, params=(), flags=0):
    """Launch ``csrc/{unit}.cu``'s kernel on the current stream of
    ``device`` over the region ``n`` (x, y, z) of ``rows_`` (``rows``),
    each CTA walking ``x_chunk`` x-planes, with the scalar ``params`` and
    the unit's ``flags``. Raises when the launch fails."""
    fn = _nvcc.entry(unit, 'dtpu_probe_stream_launch', [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    ptrs, dims, org = rows_
    nn = (ctypes.c_int * 3)(*n)
    pp = (ctypes.c_double * max(len(params), 1))(*params)
    with torch.cuda.device(device):
        rc = fn(ctypes.addressof(ptrs), ctypes.addressof(dims),
                ctypes.addressof(org), ctypes.addressof(nn),
                ctypes.addressof(pp), x_chunk, flags,
                torch.cuda.current_stream(device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"{what} kernel: no tensor map "
                           f"(cuTensorMapEncodeTiled returned {-rc}; "
                           f"100000: not found)")
    _nvcc.check_launch(rc, f"{what} kernel")


def occupancy(unit, flags=0):
    """CTAs of ``csrc/{unit}.cu``'s kernel (of ``flags``) that fit on one
    SM of the current device, as the CUDA runtime computes them from its
    registers, shared memory and threads (builds the unit)."""
    fn = _nvcc.entry(unit, 'dtpu_probe_stream_occupancy',
                     [ctypes.c_int, ctypes.c_void_p])
    ctas = ctypes.c_int(0)
    _nvcc.check_launch(fn(flags, ctypes.addressof(ctas)), "occupancy query")
    return ctas.value
