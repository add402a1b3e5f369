"""Probe 7: the parts of an x-tiled step's cost on the card -- streamed
window copies (A, K10), arithmetic on resident windows (B, K11), an empty
launch (C, K12), and copy pipelines of depth 2 (D, K13) and d (E, K14)
inside one launch.

Ports ``experiments/stencil_probe7.py``. Buffers are (NY, NY, ZA) fp32
with NY = N + 16 (x-halo H = 8 rows per side) and, on the card, ZA = NY:
the JAX script's 384-lane z is a TPU layout. The functions take any
ZA >= NY, so that the same arrays can go through both packages.

- A: ``copy_windows`` walks the x-chunks of t0 rows of src[H:H+N] in
  order with nwin windows of each in flight and, with write-back, stores
  ``out[H:H+N] = src[H:H+N] + 1`` (``csrc/probe7_copy.cu``: TMA boxes
  through a ring of ``depth`` slots fed by a producer warp, and TMA stores
  from two staging windows, on the tile of ``copy_tile``).
- B: ``resident_step`` computes probe_B's damped SO=8 update reps times
  over t0 x-rows of the N x N interior from constant windows held in
  shared memory (``csrc/probe7_resident.cu``); u may instead vary with
  position, so that the check sees the Laplacian. Its (8, 128) output
  holds the first x-row's update at the interior corner; the JAX kernel's
  output reads scratch rows it never writes.
- C: ``empty_grid`` launches reps CTAs, the last of which fills an
  (8, 128) output -- a new one, or ``out`` -- with reps - 1
  (``csrc/probe7_empty.cu``) through a short host path: the entry point
  resolved once, the device guard in C, the stream read raw; the probe
  also times launches replayed from a CUDA graph.
- D, E: ``stream_windows`` streams the same chunks through a ring of
  ``depth`` slots in one launch and returns the sum, in x order, of row 0,
  y 0:8, z 0:128 of every chunk (``csrc/probe7_stream.cu``: one TMA box a
  window, fed by a producer warp through full and empty barriers, on the
  tile of ``stream_tile``); D is E at depth 2.

Each probe holds its kernel against the plain version (raising on a
difference), times REPS calls and prints the JAX script's line -- for A,
D and E the GB/s of the script's byte count, which counts every window --
beside the rate of the unique bytes (src read once, out written once), the
share of the bound on the card, the tile and the CTAs per SM.

    python -m devito_tpu_torch.experiments.stencil_probe7 A [t0 nwin wb|nowb [nsplit]]
    python -m devito_tpu_torch.experiments.stencil_probe7 B [none|z|full]
    python -m devito_tpu_torch.experiments.stencil_probe7 C
    python -m devito_tpu_torch.experiments.stencil_probe7 D [t0 nwin]
    python -m devito_tpu_torch.experiments.stencil_probe7 E [t0 nwin depth]

each with ``[--device cuda|cpu] [--n N] [--za ZA]``.
"""

import argparse
import ctypes

import numpy as np
import torch

from . import bound_ms, device_for, time_ms
from ..kernels import _nvcc
from ..logger import debug

__all__ = ['copy_windows', 'copy_windows_reference', 'resident_step',
           'resident_step_reference', 'resident_update', 'u_window',
           'copy_tiles', 'copy_tile', 'copy_occupancy',
           'empty_grid', 'empty_launcher', 'empty_grid_reference',
           'stream_windows', 'stream_windows_reference',
           'stream_needs', 'stream_tiles', 'stream_tile', 'stream_occupancy',
           'resident_tile', 'resident_tiles', 'resident_instantiation',
           'resident_occupancy', 'inputs', 'probe_A', 'probe_B', 'probe_C',
           'probe_D', 'probe_E', 'main']

N = 256
H = 8          # x-halo rows per side
R = 4          # stencil radius (SO=8 second derivative)
NY = N + 2 * H
W = [-205.0 / 72, 8.0 / 5, -1.0 / 5, 8.0 / 315, -1.0 / 560]
TAPS = ('none', 'z', 'full')
#: probe_B's window fills: u, u1, vp, damp.
FILLS = (0.01, 0.01, 1.5, 0.0)
#: Fills and u's variation with position (``resident_step``'s ``vary``)
#: under which the Laplacian outweighs the other terms: a = 100 / vp^2 is
#: small, so the update is 2 u - u1 + 9 lap.
VARIED = ((1.0, 0.5, 30.0, 0.0), 1.0)
#: fp32 operations of probe_B's update per point, by taps: the Laplacian's
#: 1, plus 3 ('z') or 7 ('full') for each k = 1..4, and 13 for the rest.
FLOPS = {'none': 14, 'z': 26, 'full': 42}
OUT = (8, 128)  # the output tile of B, C, D and E
REPS = 24       # timed calls of A, B, D, E: the JAX script's 3 loops of 8
LOOP = 64       # calls in one of C's timed loops, as in the JAX script
TOL = 1e-5      # times max |plain|: K11's fp32 update in another order
DEPTHS = range(1, 9)

#: K10 (window copy) kernel launches.
copy_launches = 0
#: K11 (resident step) kernel launches.
resident_launches = 0
#: K12 (empty grid) kernel launches.
empty_launches = 0
#: K13 and K14 (window stream) kernel launches, by pipeline depth.
stream_launches = {}

_SMEM = 232448     # bytes of shared memory a block may use on Hopper
_SM_SMEM = 233472  # bytes of shared memory of one SM
_CTA_SMEM = 1024   # bytes the runtime keeps for each resident CTA
#: Threads of a K10, K13 or K14 CTA: four consumer warps and the producer
#: warp.
_RING_THREADS = 160
#: Shared bytes of such a CTA besides its windows: alignment slack and the
#: full and empty barriers (``smem_bytes`` in csrc/probe7_ring.cuh).
_RING_FIXED = 256
#: The (TY, TZ) tiles K10, K13 and K14 may take.
STREAM_TYS = (1, 2, 4, 8)
STREAM_TZS = (64, 128, 256)
#: K10's ring depth when none is asked for, pinned by chip_smoke.py's
#: sweep (PERF.md §6).
COPY_DEPTH = 3
#: K10's staging windows of the write-back (``STAGES`` in
#: csrc/probe7_copy.cu).
COPY_STAGES = 2
_K11_TZ = 32       # z extent of a K11 tile
_K11_MIN_THREADS = 10  # a K11 CTA fills a 40-float u row in 16-byte stores
#: The t0 of K11's unrolled instantiations at the pick by shape; any other
#: t0 takes the generic one.
RESIDENT_T0 = 16
#: K11's candidate tiles: TY (a CTA owns (TY, 32) of (y, z)) and ROWS
#: (the x-rows a thread walks, unrolled; 0: all t0, generic).
RESIDENT_TYS = (4, 8, 16)
RESIDENT_ROWS = (2, 4, 8)
#: K11's tile (TY, ROWS) at t0 = RESIDENT_T0, pinned by chip_smoke.py's
#: sweep (PERF.md §6).
RESIDENT_TILE = (16, 4)
#: K11 launches by instantiation ('unrolled', 'generic').
resident_picks = {'unrolled': 0, 'generic': 0}


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _device(device):
    """``torch.device(device)``, made once for each value of ``device``."""
    dev = _devices.get(device)
    if dev is None:
        dev = _devices[device] = torch.device(device)
    return dev


_devices = {}
_resident_logged = set()
_F32 = torch.float32
#: K12's ctypes entry point, once ``empty_launcher`` has built it.
_empty_entry = None


def _name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'


def _ctas_per_sm(smem, threads):
    """CTAs of ``threads`` threads using ``smem`` bytes of shared memory
    that fit on one SM (registers not counted)."""
    return min(_SM_SMEM // (smem + _CTA_SMEM), 2048 // threads)


def _ring_tiles(windows, t0):
    """Every (TY, TZ) tile of K10, K13 and K14 whose ``windows`` windows of
    (t0, TY, TZ) fp32 fit a block's shared memory, as ((TY, TZ), shared
    bytes, CTAs per SM (registers not counted)), fewest bytes a CTA first,
    then the wider TZ."""
    tiles = [((ty, tz), _RING_FIXED + 4 * windows * t0 * ty * tz)
             for ty in STREAM_TYS for tz in STREAM_TZS]
    return [(tile, b, _ctas_per_sm(b, _RING_THREADS)) for tile, b in
            sorted(tiles, key=lambda t: (t[1], -t[0][1])) if b <= _SMEM]


def _first(what, fits):
    if not fits:
        raise ValueError(f"the {what} kernel's windows do not fit in "
                         f"{_SMEM} bytes of shared memory")
    return fits[0]


def _fit(fits, tile):
    """The record of ``tile`` in ``fits``; raises when it is not there."""
    fit = next((f for f in fits if f[0] == tile), None)
    if fit is None:
        raise ValueError(f"tile {tile}: expected (TY, TZ) with TY in "
                         f"{STREAM_TYS} and TZ in {STREAM_TZS} whose ring "
                         f"fits in {_SMEM} bytes of shared memory")
    return fit


def _depth(depth):
    if depth not in DEPTHS:
        raise ValueError(f"depth={depth}: expected {DEPTHS.start} to "
                         f"{DEPTHS.stop - 1}")
    return depth


def copy_tiles(depth, nwin, t0, writeback=True):
    """Every (TY, TZ) tile of K10 whose ring of ``depth`` slots of nwin
    windows of (t0, TY, TZ) fp32, and with ``writeback`` its COPY_STAGES
    staging windows, fit a block's shared memory, as ``stream_tiles``
    lists them."""
    return _ring_tiles(depth * nwin + COPY_STAGES * bool(writeback), t0)


def copy_tile(depth, nwin, t0, writeback=True):
    """The (TY, TZ) tile of K10 for a ring of ``depth`` slots of nwin
    windows of t0 rows: with one window a chunk the widest TZ of TY 1 that
    lets two CTAs share an SM, else the first of ``copy_tiles``, (1, 64),
    which lets the most share one. In chip_smoke.py's sweep at N=512, t0
    16, depths 2-4, (1, 64) was the fastest TY 1 tile at nwin 4 with
    write-back, and at nwin 1 (1, 256) was 4-8 % faster than (1, 64) with
    write-back: its rows of out are 1 KB long (PERF.md §6). Returns ((TY,
    TZ), shared bytes, CTAs per SM); raises when no tile fits."""
    fits = copy_tiles(depth, nwin, t0, writeback)
    wide = [f for f in fits if nwin == 1 and f[0][0] == 1 and f[2] >= 2]
    if wide:
        return max(wide, key=lambda f: f[0][1])
    return _first('window-copy', fits)


def _copy_fit(depth, nwin, t0, writeback, tile):
    if tile is None:
        return copy_tile(depth, nwin, t0, writeback)
    return _fit(copy_tiles(depth, nwin, t0, writeback), tile)


def stream_tiles(depth, nwin, t0):
    """Every (TY, TZ) tile of K13/K14 whose ring of ``depth`` slots of nwin
    windows of (t0, TY, TZ) fp32 fits a block's shared memory, as
    ((TY, TZ), shared bytes, CTAs per SM (registers not counted)), fewest
    bytes a CTA first, then the wider TZ."""
    return _ring_tiles(depth * nwin, t0)


def stream_tile(depth, nwin, t0):
    """The (TY, TZ) tile of K13/K14 for a ring of ``depth`` slots of nwin
    windows of t0 rows: the first of ``stream_tiles``, (1, 64), which lets
    the most CTAs share an SM: in chip_smoke.py's sweep of every tile at
    N=512, t0 16, nwin 1 and 4, depths 2-4, it was the fastest or within
    4 % of it (PERF.md §6). Returns ((TY, TZ), shared bytes, CTAs per SM);
    raises when no tile fits."""
    return _first('window-stream', stream_tiles(depth, nwin, t0))


def _stream_fit(depth, nwin, t0, tile):
    """``stream_tile``'s record of the given tile; raises when it is not
    one of K13/K14's tiles or does not fit."""
    if tile is None:
        return stream_tile(depth, nwin, t0)
    return _fit(stream_tiles(depth, nwin, t0), tile)


def resident_tiles(t0):
    """Every tile (TY, ROWS) of K11 for t0 x-rows whose windows fit a
    block's shared memory: a CTA owns (TY, 32) points of the (y, z) plane,
    each thread 4 z-neighbours of them over ROWS x-rows (0: all t0 rows in
    a runtime loop, the generic instantiation; else ROWS divides t0 and
    the walk is unrolled), with at least 10 threads a CTA and at most the
    instantiation's ``__launch_bounds__`` (``_k11_max_threads``). Records
    ((TY, ROWS), shared bytes, threads a CTA, CTAs per SM (registers not
    counted), warps per SM), in the order of RESIDENT_TYS, RESIDENT_ROWS."""
    recs = []
    for ty in RESIDENT_TYS:
        b = 4 * ((t0 + 2 * R) * (ty + 2 * R) * (_K11_TZ + 2 * R)
                 + 3 * t0 * ty * _K11_TZ)
        for rows in (0,) + RESIDENT_ROWS:
            if rows and t0 % rows:
                continue
            threads = ty * (_K11_TZ // 4) * (t0 // rows if rows else 1)
            if b > _SMEM or not \
                    _K11_MIN_THREADS <= threads <= _k11_max_threads(rows):
                continue
            ctas = _ctas_per_sm(b, threads)
            recs.append(((ty, rows), b, threads, ctas, ctas * threads // 32))
    return recs


def _k11_max_threads(rows):
    """``max_threads`` of csrc/probe7_resident.cu: the most threads a CTA
    of the instantiation for ``rows`` takes."""
    return 128 if rows == 0 else 512 if rows <= 4 else 2048 // rows


def resident_tile(t0, tile=None):
    """K11's tile for t0 x-rows, as ``resident_tiles`` records it: ``tile``
    when given (raises unless it is one of them), else the pick by shape.
    At t0 = RESIDENT_T0 the unrolled RESIDENT_TILE; at any other t0 the
    generic instantiation, (TY, 0) with the largest TY of 8, 4 and 2 that
    lets two CTAs share an SM, else the largest that fits. Raises when no
    tile fits."""
    fits = resident_tiles(t0)
    if tile is not None:
        fit = next((f for f in fits if f[0] == tuple(tile)), None)
        if fit is None:
            raise ValueError(
                f"tile {tile}: expected (TY, ROWS) with TY in "
                f"{RESIDENT_TYS} and ROWS 0 or one of {RESIDENT_ROWS} "
                f"dividing t0={t0}, whose windows fit in {_SMEM} bytes of "
                f"shared memory")
        return fit
    if t0 == RESIDENT_T0:
        return resident_tile(t0, RESIDENT_TILE)
    generic = [f for ty in (8, 4, 2) for f in fits if f[0] == (ty, 0)]
    if not generic:
        raise ValueError(f"the resident-step kernel's windows do not fit in "
                         f"{_SMEM} bytes of shared memory at t0={t0}")
    return next((f for f in generic if f[3] >= 2), generic[0])


def resident_instantiation(tile):
    """'unrolled' or 'generic': the kernel instantiation of a K11 tile."""
    return 'unrolled' if tile[1] else 'generic'


def _buffer(what, src):
    """N of the (N+16, N+16, ZA) fp32 buffer ``src``; raises on another."""
    if not isinstance(src, torch.Tensor) or src.dtype != torch.float32 \
            or src.dim() != 3 or not src.is_contiguous():
        raise TypeError(f"the {what} takes a contiguous 3-D fp32 tensor")
    ny, za = src.shape[0], src.shape[2]
    n = ny - 2 * H
    if n < 1 or src.shape[1] != ny or za < ny:
        raise ValueError(f"buffer shape {tuple(src.shape)}: expected "
                         f"(N+16, N+16, ZA) with ZA >= N+16")
    if src.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"no {what} kernel for device {src.device}")
    return n


def _chunks(n, t0, nwin):
    if t0 < 1 or n % t0:
        raise ValueError(f"t0={t0} does not divide N={n}")
    if nwin < 1:
        raise ValueError(f"nwin={nwin}: expected at least one window")


def _on_card(what, src):
    if src.shape[2] % 4 or src.data_ptr() % 16:
        raise ValueError(f"the {what} kernel needs ZA % 4 == 0 and a 16-byte "
                         f"aligned tensor")


# -- K10: streamed window copies -------------------------------------------------

def copy_windows(src, t0=16, nwin=4, writeback=True, nsplit=1, tile=None,
                 depth=None):
    """K10: a new buffer shaped like ``src`` whose rows [H, H+N) hold
    src + 1 when ``writeback``; its x-halo rows, and without write-back all
    of it, are left unset, as in the TPU probe. The kernel walks the
    x-chunks of t0 rows in order through a ring of ``depth`` (default
    COPY_DEPTH) slots of nwin windows, each window loaded in nsplit row
    blocks, and stores window 0 + 1 from COPY_STAGES staging windows; on
    ``tile`` (TY, TZ) of
    ``copy_tiles`` or, by default, ``copy_tile``'s. CUDA tensors go through
    the kernel; CPU tensors through ``copy_windows_reference``."""
    global copy_launches
    n = _buffer('window-copy', src)
    _chunks(n, t0, nwin)
    if nsplit < 1 or t0 % nsplit:
        raise ValueError(f"nsplit={nsplit} does not divide t0={t0}")
    depth = _depth(COPY_DEPTH if depth is None else depth)
    (ty, tz), _, _ = _copy_fit(depth, nwin, t0, writeback, tile)
    if src.device.type == 'cpu':
        return copy_windows_reference(src, t0, nwin, writeback, nsplit)
    _on_card('window-copy', src)
    out = torch.empty_like(src)
    fn = _nvcc.entry('probe7_copy', 'dtpu_probe7_copy_launch',
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
                     + [ctypes.c_void_p])
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), out.data_ptr(), src.shape[0], src.shape[2],
                n, t0, nwin, nsplit, int(bool(writeback)), depth, ty, tz,
                _stream(src.device))
    _nvcc.check_launch(rc, "window-copy kernel")
    copy_launches += 1
    return out


def copy_occupancy(t0=16, nwin=4, depth=None, tile=None, writeback=True,
                   device='cuda'):
    """The CTAs of K10 on ``tile`` (default ``copy_tile``'s) that fit on
    one SM of ``device``, as the CUDA runtime counts them from the kernel's
    registers, shared memory and threads."""
    depth = _depth(COPY_DEPTH if depth is None else depth)
    (ty, tz), _, _ = _copy_fit(depth, nwin, t0, writeback, tile)
    fn = _nvcc.entry('probe7_copy', 'dtpu_probe7_copy_occupancy',
                     [ctypes.c_int] * 6 + [ctypes.c_void_p])
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(nwin, t0, depth, ty, tz, int(bool(writeback)),
                ctypes.addressof(ctas))
    _nvcc.check_launch(rc, "window-copy occupancy query")
    return ctas.value


def copy_windows_reference(src, t0=16, nwin=4, writeback=True, nsplit=1):
    """The plain PyTorch version of ``copy_windows`` (its result does not
    depend on t0, nwin or nsplit)."""
    n = _buffer('window-copy', src)
    out = torch.empty_like(src)
    if writeback:
        out[H:H + n] = src[H:H + n] + 1.0
    return out


# -- K11: the update on resident windows -----------------------------------------

def _resident_args(t0, reps, taps, fills, n):
    """Checks the arguments of K11; returns its fills as floats."""
    if taps not in TAPS:
        raise ValueError(f"taps {taps!r}: expected one of {TAPS}")
    if t0 < 1 or reps < 1 or n < 1:
        raise ValueError(f"t0={t0}, reps={reps}, n={n}: expected positive")
    if len(fills) != 4:
        raise ValueError("fills: expected the four values u, u1, vp, damp")
    return [float(f) for f in fills]


def resident_step(t0=16, reps=16, taps='full', fills=FILLS, n=N,
                  device='cuda', vary=0.0, tile=None, fast_div=False):
    """K11: probe_B's update computed ``reps`` times over t0 x-rows of the
    n x n interior, from windows holding the constant ``fills`` (u, u1, vp,
    damp) -- u times ``1 + vary * pattern`` (``u_window``) when vary is
    not 0. Returns an (8, 128) fp32 tensor of zeros whose [:min(8, n),
    :min(128, n)] holds the first x-row's update at the interior corner (y
    and z from H). On a CUDA device the kernel computes it from shared
    memory, reading nothing from device memory, on ``tile`` (default
    ``resident_tile``'s pick by shape, logged at the first launch of each
    pick and counted by instantiation in ``resident_picks``), dividing
    with ``__fdividef`` when ``fast_div``; on the CPU
    ``resident_step_reference`` does, after the same checks."""
    global resident_launches
    fills = _resident_args(t0, reps, taps, fills, n)
    dev = torch.device(device)
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f"no resident-step kernel for device {dev}")
    (ty, rows), _, threads, _, _ = fit = resident_tile(t0, tile)
    if dev.type == 'cpu':
        return resident_step_reference(t0, reps, taps, fills, n, vary=vary)
    kind = resident_instantiation(fit[0])
    if (t0, fit[0], bool(fast_div)) not in _resident_logged:
        _resident_logged.add((t0, fit[0], bool(fast_div)))
        debug(f"resident-step kernel at t0={t0}: tile (TY, ROWS) "
              f"{fit[0]}, the {kind} instantiation"
              + (", __fdividef" if fast_div else ""))
    ctas = -(-n // _K11_TZ) * -(-n // ty)
    out = torch.empty(OUT, dtype=torch.float32, device=dev)
    sink = torch.empty(ctas * threads, dtype=torch.float32, device=dev)
    f = (ctypes.c_float * 4)(*fills)
    fn = _nvcc.entry('probe7_resident', 'dtpu_probe7_resident_launch',
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(out.data_ptr(), sink.data_ptr(), n, t0, reps,
                TAPS.index(taps), ty, rows, int(bool(fast_div)), f,
                float(vary), _stream(out.device))
    _nvcc.check_launch(rc, "resident-step kernel")
    resident_launches += 1
    resident_picks[kind] += 1
    return out


def resident_occupancy(t0=16, taps='full', tile=None, fast_div=False,
                       device='cuda'):
    """The CTAs of K11 on ``tile`` (default ``resident_tile``'s) that fit
    on one SM of ``device``, as the CUDA runtime counts them from the
    kernel's registers, shared memory and threads."""
    if taps not in TAPS:
        raise ValueError(f"taps {taps!r}: expected one of {TAPS}")
    ty, rows = resident_tile(t0, tile)[0]
    fn = _nvcc.entry('probe7_resident', 'dtpu_probe7_resident_occupancy',
                     [ctypes.c_int] * 5 + [ctypes.c_void_p])
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(t0, TAPS.index(taps), ty, rows, int(bool(fast_div)),
                ctypes.addressof(ctas))
    _nvcc.check_launch(rc, "resident-step occupancy query")
    return ctas.value


def resident_update(ut, u1, vp, dp, taps='full'):
    """probe_B's update (``stencil_probe7.py:136-156``, DT = 0.1, h = 10)
    at the points of ``ut`` at least R from its edges: ut (X+8, Y+8, Z+8);
    u1, vp, dp (X, Y, Z). Returns (X, Y, Z)."""
    X, Y, Z = u1.shape

    def at(dx, dy, dz):
        return ut[R + dx:R + dx + X, R + dy:R + dy + Y, R + dz:R + dz + Z]

    u = at(0, 0, 0)
    lap = (3.0 * W[0]) * u
    if taps != 'none':
        for k in range(1, R + 1):
            terms = at(0, 0, k) + at(0, 0, -k)
            if taps == 'full':
                terms = (terms + at(k, 0, 0) + at(-k, 0, 0) + at(0, k, 0)
                         + at(0, -k, 0))
            lap = lap + W[k] * terms
    lap = lap * (1.0 / 100.0)
    m = 1.0 / (vp * vp)
    a = m * 100.0
    b = dp * 5.0
    return ((2.0 * a) * u - (a - b) * u1 + lap) / (a + b)


def u_window(shape, fu, vary=0.0, device='cpu'):
    """K11's u window of ``shape`` (x, y, z): fu * (1 + vary * ((7 x +
    13 y + 29 z) mod 17)) in fp32, each operation rounded on its own as the
    kernel rounds it; fu everywhere when vary is 0."""
    x, y, z = (torch.arange(s, device=device).view(
        [-1 if a == i else 1 for a in range(3)]) for i, s in enumerate(shape))
    p = ((7 * x + 13 * y + 29 * z) % 17).to(torch.float32)
    return (torch.tensor(fu, dtype=torch.float32, device=device)
            * (1.0 + torch.tensor(vary, dtype=torch.float32, device=device)
               * p))


def resident_step_reference(t0=16, reps=16, taps='full', fills=FILLS, n=N,
                            device='cpu', vary=0.0):
    """The plain PyTorch version of ``resident_step``: the update of t0
    x-rows of the n x n interior from its windows, ``reps`` times as the
    TPU grid computes it, the output taken from the last."""
    fu, f1, fv, fd = _resident_args(t0, reps, taps, fills, n)
    ut = u_window((t0 + 2 * R, n + 2 * R, n + 2 * R), fu, vary, device)
    rest = [torch.full((t0, n, n), f, dtype=torch.float32, device=device)
            for f in (f1, fv, fd)]
    for _ in range(reps):
        val = resident_update(ut, *rest, taps)
    out = torch.zeros(OUT, dtype=torch.float32, device=device)
    ny, nz = min(OUT[0], n), min(OUT[1], n)
    out[:ny, :nz] = val[0, :ny, :nz]
    return out


# -- K12: the empty grid ---------------------------------------------------------

def empty_grid(reps=16, device='cuda', out=None):
    """K12: one launch of ``reps`` CTAs, the last of which fills an (8, 128)
    fp32 tensor with reps - 1: what the TPU grid's in-order steps leave.
    The tensor is ``out`` when given -- contiguous, (8, 128), fp32, on
    ``device``; it is written, never copied, as XLA reuses the buffer
    across the JAX probe's loop -- else a new one. On the CPU
    ``empty_grid_reference``.

    The host path is short: the entry point is resolved once, the device
    guard is in C, and the stream is read raw at each call. Nothing
    synchronises, so calls may be captured in a CUDA graph;
    a captured call counts one launch, its replays none."""
    global empty_launches
    if reps < 1:
        raise ValueError(f"reps={reps}: expected at least one step")
    dev = _device(device)
    if out is not None:
        if not isinstance(out, torch.Tensor) or out.dtype is not _F32 \
                or out.shape != OUT or not out.is_contiguous():
            raise ValueError(f"out: expected a contiguous {OUT} fp32 tensor")
        at = out.device
        if at.type != dev.type or dev.index is not None and \
                at.index != dev.index:
            raise ValueError(f"out is on {at}, not on {dev}")
    if dev.type == 'cpu':
        return empty_grid_reference(reps, out=out)
    if dev.type != 'cuda':
        raise ValueError(f"no empty-grid kernel for device {dev}")
    if out is None:
        out = torch.empty(OUT, dtype=_F32, device=dev)
        at = out.device
    index = at.index
    fn = _empty_entry
    if fn is None:
        fn = empty_launcher()
    rc = fn(out.data_ptr(), reps, index,
            torch._C._cuda_getCurrentRawStream(index))
    _nvcc.check_launch(rc, "empty-grid kernel")
    empty_launches += 1
    return out


def empty_launcher():
    """K12's C entry point, ``(out pointer, reps, device index, stream) ->
    cudaError_t``, built on first use: what ``empty_grid`` calls, without
    its Python."""
    global _empty_entry
    if _empty_entry is None:
        _empty_entry = _nvcc.entry(
            'probe7_empty', 'dtpu_probe7_empty_launch',
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _empty_entry


def empty_grid_reference(reps=16, device='cpu', out=None):
    """The plain PyTorch version of ``empty_grid``; into ``out`` when
    given."""
    if out is not None:
        return out.fill_(float(reps - 1))
    return torch.full(OUT, float(reps - 1), dtype=torch.float32,
                      device=device)


def _replay_us(fn, device, calls=LOOP, replays=8):
    """``calls`` calls of ``fn`` captured in one CUDA graph on ``device``:
    (microseconds a call when the graph is replayed, timed over ``replays``
    replays after one, the graph)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, replays, device) / calls * 1e3, graph


# -- K13, K14: read pipelines in one launch --------------------------------------

def stream_windows(src, t0=16, nwin=4, depth=3, tile=None):
    """K13 (depth 2) and K14: the (8, 128) sum, in x order, of
    src[H + i t0, 0:8, 0:128] over the x-chunks i of src[H:H+N]. The kernel
    streams every chunk's nwin windows, one TMA box each, through a ring of
    ``depth`` slots, depth - 1 chunks in flight beyond the one waited for,
    on ``tile`` (TY, TZ) or, by default, ``stream_tile``'s. CUDA tensors go
    through the kernel; CPU tensors through ``stream_windows_reference``."""
    n = _buffer('window-stream', src)
    _chunks(n, t0, nwin)
    _depth(depth)
    if src.shape[2] < OUT[1]:
        raise ValueError(f"ZA={src.shape[2]}: the output tile is z 0:128")
    if src.device.type == 'cpu':
        if tile is not None:
            _stream_fit(depth, nwin, t0, tile)
        return stream_windows_reference(src, t0, nwin, depth)
    _on_card('window-stream', src)
    (ty, tz), _, _ = _stream_fit(depth, nwin, t0, tile)
    out = torch.empty(OUT, dtype=torch.float32, device=src.device)
    fn = _nvcc.entry('probe7_stream', 'dtpu_probe7_stream_launch',
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p])
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), out.data_ptr(), src.shape[0], src.shape[2],
                n, t0, nwin, depth, ty, tz, _stream(src.device))
    _nvcc.check_launch(rc, "window-stream kernel")
    stream_launches[depth] = stream_launches.get(depth, 0) + 1
    return out


def stream_occupancy(t0=16, nwin=4, depth=3, tile=None, device='cuda'):
    """The CTAs of K13/K14 on ``tile`` (default ``stream_tile``'s) that fit
    on one SM of ``device``, as the CUDA runtime counts them from the
    kernel's registers, shared memory and threads."""
    (ty, tz), _, _ = _stream_fit(depth, nwin, t0, tile)
    fn = _nvcc.entry('probe7_stream', 'dtpu_probe7_stream_occupancy',
                     [ctypes.c_int] * 5 + [ctypes.c_void_p])
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(nwin, t0, depth, ty, tz, ctypes.addressof(ctas))
    _nvcc.check_launch(rc, "window-stream occupancy query")
    return ctas.value


def stream_needs(n, t0):
    """The bytes and fp32 additions ``stream_windows``'s result needs: the
    (8, 128) tile of each of the n / t0 chunks read once, the sum written
    once -- not the n (n+16) ZA floats the kernel streams."""
    tile, chunks = OUT[0] * OUT[1], n // t0
    return 4 * tile * (chunks + 1), tile * chunks


def stream_windows_reference(src, t0=16, nwin=4, depth=3):
    """The plain PyTorch version of ``stream_windows``: the reference's
    accumulator loop, in the same order."""
    n = _buffer('window-stream', src)
    acc = torch.zeros(OUT, dtype=torch.float32, device=src.device)
    for i in range(n // t0):
        acc = acc + src[H + i * t0, :OUT[0], :OUT[1]]
    return acc


# -- the probes ------------------------------------------------------------------

def inputs(n=N, za=None, seed=0, device='cuda'):
    """An (n+16, n+16, za) fp32 buffer, standard normal from numpy's
    generator ``seed``; za defaults to n + 16."""
    ny = n + 2 * H
    a = np.random.default_rng(seed).standard_normal(
        (ny, ny, za or ny)).astype(np.float32)
    return torch.from_numpy(a).to(device)


def _rates(dev, ms, agg, uniq, need, flops, tile, ctas):
    """The record of a copy probe and the text after its script line: the
    rates of the script's byte count ``agg`` and of the ``uniq`` bytes the
    kernel streams from device memory once, the bound of those bytes
    (``stream_*``), and the bound of the ``need`` bytes and ``flops`` that
    the probe's result needs (``bound_ms``, ``share``)."""
    on_card = dev.type == 'cuda'
    bms, by = bound_ms(need, flops)
    sms = bound_ms(uniq, 0)[0]
    rec = {'ms': ms, 'gbs_agg': agg / ms / 1e6, 'gbs_unique': uniq / ms / 1e6,
           'bytes_agg': agg, 'bytes_unique': uniq, 'stream_bound_ms': sms,
           'stream_share': sms / ms if on_card else None,
           'bytes_needed': need, 'bound_ms': bms, 'bound_by': by,
           'share': bms / ms if on_card else None, 'tile': tile,
           'ctas_per_sm': ctas, 'device': _name(dev)}
    text = f"{rec['gbs_unique']:.0f} GB/s unique of {uniq / 1e6:.1f} MB"
    if on_card:
        text += (f", {100 * rec['stream_share']:.1f} % of the bound of the "
                 f"streamed bytes ({sms:.4f} ms)")
        if need != uniq:
            text += (f"; the result's own bound {bms:.6f} ms ({by}) = "
                     f"{100 * rec['share']:.3f} %")
    return rec, text + f"; tile {tile}, {ctas} CTAs/SM on {rec['device']}"


def probe_A(t0=16, nwin=4, writeback=True, nsplit=1, n=N, za=None,
            device='cuda'):
    """The JAX script's probe A on K10: the kernel against its plain
    version (interior rows equal to the bit), then REPS calls, each fed
    the last one's output, timed."""
    dev = device_for(device)
    src = inputs(n, za, device=dev)
    ny, za = src.shape[0], src.shape[2]
    got = copy_windows(src, t0, nwin, writeback, nsplit)
    if writeback and not torch.equal(
            got[H:H + n], copy_windows_reference(src)[H:H + n]):
        raise AssertionError("K10 wrote other interior rows than its plain "
                             "version")
    x = [src]

    def step():
        x[0] = copy_windows(x[0], t0, nwin, writeback, nsplit)

    ms = time_ms(step, REPS, dev)
    S = n * ny * za * 4
    tile, _, ctas = copy_tile(COPY_DEPTH, nwin, t0, writeback)
    uniq = (1 + bool(writeback)) * S
    rec, text = _rates(dev, ms, (nwin + 2 * bool(writeback)) * S, uniq, uniq,
                       bool(writeback) * S // 4, tile, ctas)
    print(f"A t0={t0} nwin={nwin} wb={bool(writeback)} nsplit={nsplit}: "
          f"{ms:.4f} ms/step -> {rec['gbs_agg']:.0f} GB/s agg DMA; {text}",
          flush=True)
    return dict(rec, probe='A', t0=t0, nwin=nwin, writeback=bool(writeback),
                nsplit=nsplit, n=n, za=za)


def probe_B(t0=16, reps=16, taps='full', n=N, device='cuda'):
    """The JAX script's probe B on K11: the kernel against its plain
    version (within TOL), then REPS calls timed; reps x t0 x n x n points
    a call (one virtual step of n^3 when reps = n / t0)."""
    dev = device_for(device)
    got = resident_step(t0, reps, taps, FILLS, n, dev)
    want = resident_step_reference(t0, reps, taps, FILLS, n, dev)
    err = (got - want).abs().max().item()
    tol = TOL * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"K11 taps={taps}: max|kernel - plain| {err} > "
                             f"{tol}")
    ms = time_ms(lambda: resident_step(t0, reps, taps, FILLS, n, dev), REPS,
                 dev)
    pts = t0 * n * n * reps
    flops = FLOPS[taps] * pts
    bms, by = bound_ms(4 * OUT[0] * OUT[1], flops)
    (ty, rows), smem, threads, ctas, _ = resident_tile(t0)
    if dev.type == 'cuda':
        ctas = resident_occupancy(t0, taps, device=dev)
    share = bms / ms if dev.type == 'cuda' else None
    print(f"B t0={t0} taps={taps}: {ms:.4f} ms/virtual-step -> "
          f"{pts / ms / 1e6:.1f} GPts/s compute-only; "
          f"{flops / ms / 1e9:.2f} TFLOP/s"
          + (f", {100 * share:.1f} % of the bound ({bms:.4f} ms, {by})"
             if share is not None else '')
          + f"; max|kernel - plain| {err:.2e}; tile ({ty}, {_K11_TZ}), "
          f"4 points a thread over {rows or t0} rows "
          f"({resident_instantiation((ty, rows))}), {threads} threads, "
          f"{smem} B shared, {ctas} CTAs/SM on {_name(dev)}", flush=True)
    return {'probe': 'B', 't0': t0, 'reps': reps, 'taps': taps, 'n': n,
            'ms': ms, 'gpts': pts / ms / 1e6, 'tflops': flops / ms / 1e9,
            'bound_ms': bms, 'bound_by': by, 'share': share, 'err': err,
            'tol': tol, 'tile': (ty, _K11_TZ),
            'rows': rows, 'threads': threads, 'smem_bytes': smem,
            'ctas_per_sm': ctas, 'device': _name(dev)}


def probe_C(reps=16, device='cuda'):
    """The JAX script's probe C on K12: the kernel against its plain
    version, allocating and into one ``out``; then LOOP calls each added to
    a carry, as the JAX loop does, LOOP bare launches allocating and LOOP
    into ``out``, beside LOOP of ``torch.full`` and of ``out.fill_``, the
    PyTorch calls that compute the same, each loop timed 3 times. On the
    card also LOOP calls of the bare ctypes entry, and LOOP launches into
    ``out`` captured in one CUDA graph and replayed -- the JAX loop's cost
    of a launch with no host in it -- beside ``fill_`` replayed, the
    replay checked against the plain version. Microseconds per call, by
    name, in ``us_per_call``."""
    dev = device_for(device)
    want = empty_grid_reference(reps, dev)
    out = torch.empty(OUT, dtype=torch.float32, device=dev)
    if not (torch.equal(empty_grid(reps, dev), want)
            and torch.equal(empty_grid(reps, dev, out), want)):
        raise AssertionError(f"K12 did not leave {reps - 1}")
    carry = torch.zeros(OUT, dtype=torch.float32, device=dev)
    val = float(reps - 1)

    def added():
        acc = carry
        for _ in range(LOOP):
            acc = empty_grid(reps, dev) + acc

    def loop(fn):
        def run():
            for _ in range(LOOP):
                fn()
        return run

    calls = {'add': added, 'alloc': loop(lambda: empty_grid(reps, dev)),
             'torch.full': loop(lambda: torch.full(OUT, val, device=dev)),
             'out': loop(lambda: empty_grid(reps, dev, out)),
             'fill_': loop(lambda: out.fill_(val))}
    if dev.type == 'cuda':
        fn, index = empty_launcher(), out.device.index
        ptr = out.data_ptr()
        stream = torch._C._cuda_getCurrentRawStream(index)
        calls['ctypes'] = loop(lambda: fn(ptr, reps, index, stream))
    us = {k: time_ms(f, 3, dev) / LOOP * 1e3 for k, f in calls.items()}
    if dev.type == 'cuda':
        us['graph'], graph = _replay_us(lambda: empty_grid(reps, dev, out),
                                       dev)
        out.zero_()
        graph.replay()
        if not torch.equal(out, want):
            raise AssertionError(f"K12 replayed did not leave {reps - 1}")
        us['graph fill_'] = _replay_us(lambda: out.fill_(val), dev)[0]
    text = (f"C: {us['add']:.1f} us per {reps}-CTA launch and add, "
            f"{us['alloc']:.1f} us per bare launch (torch.full "
            f"{us['torch.full']:.1f}), {us['out']:.1f} us into out (fill_ "
            f"{us['fill_']:.1f})")
    if 'graph' in us:
        text += (f", {us['ctypes']:.1f} us through ctypes alone; replayed "
                 f"from a CUDA graph {us['graph']:.2f} us a launch (fill_ "
                 f"{us['graph fill_']:.2f})")
    print(f"{text} on {_name(dev)}", flush=True)
    return {'probe': 'C', 'reps': reps, 'us_per_call': us,
            'device': _name(dev)}


def _stream_probe(head, t0, nwin, depth, n, za, device):
    dev = device_for(device)
    src = inputs(n, za, device=dev)
    ny, za = src.shape[0], src.shape[2]
    if not torch.equal(stream_windows(src, t0, nwin, depth),
                       stream_windows_reference(src, t0, nwin, depth)):
        raise AssertionError(f"K13/K14 at depth {depth} differs from its "
                             f"plain version")
    ms = time_ms(lambda: stream_windows(src, t0, nwin, depth), REPS, dev)
    S = n * ny * za * 4
    tile, _, ctas = stream_tile(depth, nwin, t0)
    rec, text = _rates(dev, ms, nwin * S, S + 4 * OUT[0] * OUT[1],
                       *stream_needs(n, t0), tile, ctas)
    print(f"{head}: {ms:.4f} ms/step -> {rec['gbs_agg']:.0f} GB/s agg DMA; "
          f"{text}", flush=True)
    return dict(rec, probe=head[0], t0=t0, nwin=nwin, depth=depth, n=n,
                za=za)


def probe_D(t0=16, nwin=4, n=N, za=None, device='cuda'):
    """The JAX script's probe D on K13: E at depth 2."""
    return _stream_probe(f"D t0={t0} nwin={nwin}", t0, nwin, 2, n, za,
                         device)


def probe_E(t0=16, nwin=4, depth=3, n=N, za=None, device='cuda'):
    """The JAX script's probe E on K14: the kernel against its plain
    version (equal to the bit), then REPS calls timed."""
    return _stream_probe(f"E t0={t0} nwin={nwin} depth={depth}", t0, nwin,
                         depth, n, za, device)


def _probe_args(which, args):
    """The keyword arguments of probe ``which`` from the JAX script's
    positional form (every argument optional here)."""
    forms = {'A': ('t0', 'nwin', 'writeback', 'nsplit'), 'B': ('taps',),
             'C': (), 'D': ('t0', 'nwin'), 'E': ('t0', 'nwin', 'depth')}
    if which not in forms:
        raise ValueError(f"probe {which!r}: expected one of A, B, C, D, E")
    if len(args) > len(forms[which]):
        raise ValueError(f"probe {which} takes at most "
                         f"{len(forms[which])} arguments: "
                         f"{' '.join(forms[which])}")
    kw = {}
    for name, a in zip(forms[which], args):
        if name == 'writeback':
            if a not in ('wb', 'nowb'):
                raise ValueError(f"{a!r}: expected wb or nowb")
            kw[name] = a == 'wb'
        elif name == 'taps':
            if a not in TAPS:
                raise ValueError(f"taps {a!r}: expected one of {TAPS}")
            kw[name] = a
        else:
            kw[name] = int(a)
    return kw


def main(which='C', *args, device='cuda', n=N, za=None):
    """Probe ``which`` with the JAX script's positional ``args`` (strings)
    at interior size ``n`` (and ZA ``za``, default n + 16) on ``device``;
    returns its record."""
    kw = _probe_args(which, args)
    if which in 'ADE':
        kw.update(n=n, za=za)
    elif which == 'B':
        kw.update(n=n)
    probe = {'A': probe_A, 'B': probe_B, 'C': probe_C, 'D': probe_D,
             'E': probe_E}[which]
    return probe(device=device, **kw)


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('which', nargs='?', default='C', choices=list('ABCDE'))
    ap.add_argument('args', nargs='*',
                    help="A: t0 nwin wb|nowb [nsplit]; B: taps; D: t0 nwin; "
                         "E: t0 nwin depth")
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--n', type=int, default=N,
                    help='interior size N (default 256)')
    ap.add_argument('--za', type=int, default=None,
                    help='z allocation ZA >= N + 16 (default N + 16)')
    a = ap.parse_args()
    main(a.which, *a.args, device=a.device, n=a.n, za=a.za)
